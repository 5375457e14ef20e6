"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py [--out DIR] [--baseline-csrc DIR]

Phases, each of which raises on failure (exit code non-zero):

1. Device: refuse to run without CUDA; print the card's name and power
   limit as nvidia-smi gives them.
2. Build: compile the ten CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one nvcc per source, in parallel); print the build time, what
   ptxas reports for each kernel and, from ``cuobjdump -sass``, how many
   wgmma (HGMMA), TMA loads (UTMALDG), mma.sync (HMMA.16816) and
   wgmma waits each library holds.
3. Kernels: each kernel against its plain torch version on the card, at the
   llama-1b main-path shapes (prefill B 4, S 256, so M = 1024; decode B 4
   over a 296-slot cache; paged decode over 8 slots of an 8-page bucket of
   a 65-page pool, a 128-token chunk at position 192 and a 4-token verify,
   which also runs over a 16-page bucket (two splits), each verify row
   held bit for bit to the serial T = 1 call at its position (required at
   one split, recorded at two); the forward GEMM at the verify step's
   M = 32 (q|k + rope, v, the SwiGLU up, the down + residual), rows 0-7
   bit for bit the M = 8 call's;
   the flash forward at served prefill (B 4, S 256), the paged engine's
   lone-sequence prefill (B 1, S 256) and training (B 4, S 1024), q, k and
   v strided views of the projections as the model passes them;
   the forward GEMM's prefill, decode and training (M = 4096) launches,
   the gated one saving its preacts as autograd does, each also at every
   tile width and split count against the planner's pick; and its
   launches in phase 9 (whisper-base's encoder over 4 x 1500 frames:
   q|k, v and the gelu up projection on the layernorm + beta prologue, the
   down projection's residual store; the decoder's prefill (M 256) and
   decode step (M 4, split over K); bert-110m's at M 4096; a gated gelu
   at the encoder's shape), each layernorm row also timed on the rmsnorm
   prologue, the cost of layernorm's second pass over the row; the flash
   forward also at whisper's non-causal encoder (S 1500), its causal
   prefill and its cross attention (64 queries over 1500 frames), and
   bert's 8 x 512; the contiguous decode kernel also at whisper's self and
   cross (1500 slots) steps;
   the training backward at B 4, S 1024, so M = 4096: the GEMM backward
   of the four fused GEMMs of a layer as its operand pass, dA (the GEMM
   and the norm row pass also timed apart) and dB, each tile width of the
   mainloop timed too, and the whole backward against the library's two
   products; the same for the training GEMMs of phases 9c and 9d (bert at
   M 4096 K 768, whisper's encoder at M 6000 K 512 and decoder at M 1792:
   q|k and v on the layernorm + beta prologue, the gelu up projection from
   its saved preact, the down projection's residual; a relu and a geglu
   chain at bert's shape), the layernorm row pass against its own bytes
   bound; the gelu up projections' forward also saving their preact as
   the training forward does; the GEMM backward at mixtral-8x7b's
   training GEMMs (phase 13: M 4096, q|k + rope at head_dim 128, v, an
   expert's gated up with no prologue and its down with no epilogue) and
   at recurrentgemma-2b's (phase 16: M 8192, q|k N 2816 and v N 256 on
   the rmsnorm prologue, the geglu up, 2 x N 7680, from its two saved
   preacts, the down K 7680 with the residual);
   the flash backward whole, its main kernel
   and its dq conversion timed apart, at llama's training shape, bert's
   non-causal 8 x 512, whisper's encoder over 1500 frames, its decoder's
   causal 4 x 448, its cross attention of 448 queries over 1500 frames
   and mixtral's training shape (B 4, H 32, Hkv 8, S 1024, d 128), each
   gradient within its tolerance of the plain version, at most one
   entry of it within the same tolerance of the fp32 truth instead
   (``check_close_to_truth``: a ds that the two round to other bf16
   neighbours);
   the standalone
   RoPE on prefill and training q/k, strided views of the q|k GEMM output,
   and its backward; the fused dropout + residual + layernorm at the
   memory-bound bench's shapes, rows 2048-8192 by d 2048, p 0.1, seed 7;
   mixtral-8x7b's launches of phase 12: q|k + rope (head_dim 128, K 4096,
   N 5120) and v (N 1024) at M 1024, an expert's dual-output silu-gated
   up projection with no prologue (2 x N 14336) and its down projection
   with no epilogue (K 14336) at M 1024 and M 4, the flash forward at B 2,
   S 4160 within the 4096-token window, ``flash_decode`` at B 4 over a
   wrapped 4096-slot ring, and ``flash_decode_paged`` within the window
   over 67-page tables, one decode step and a 128-token chunk);
   recurrentgemma-2b's (15a, head_dim 256, 10 query heads over one kv
   head): the flash forward at B 4, S 2304 causal in the 2048-token window
   and at S 1024 with no window, ``flash_decode`` over a 2048-slot ring
   wrapped to length 2335, ``flash_decode_paged`` at 8 ragged lengths
   197-2300 over 40-page tables in the window, and its four fused GEMMs
   (a local block's q|k, N 2816, without the rope store, and v, N 256, on
   the rmsnorm prologue; the geglu up, 2 x N 7680; the down, K 7680, with
   the residual store) at M = 4 x 2304 and M 4;
   with the stated tolerance; kernel, plain and library times with CUDA
   events (L2 scrubbed before every launch), and the least time the card
   could take (bytes over 3.35 TB/s or operations over their peak,
   whichever is larger: products of two bf16 operands at 989 TFLOP/s).
   First the timer's floor: a one-element fill replayed the same way, the
   fixed cost in every time below (not subtracted from any). RoPE and the
   fused norm are also timed after a scrub that reads instead of writes,
   so the L2 holds no dirty lines to write back during the kernel. The
   decode kernels are timed whole, their in-launch merge included; the
   paged kernel at page 64 and one query token must equal ``flash_decode``
   over the gathered pages bit for bit. No PyTorch call computes paged attention: its yardstick is
   ``F.scaled_dot_product_attention`` over the pre-gathered cache, the
   gather not timed. The GEMM backward's yardstick is ``torch.matmul`` of
   the bare product (the operand pass has none). The flash backward's
   yardstick is ``torch.autograd.grad`` through
   ``F.scaled_dot_product_attention``, replayed from a CUDA graph like
   every other yardstick, its grads first held to the plain version (1% in
   norm; the entries outside the kernel's tolerance counted). With
   ``--baseline-csrc DIR`` (an earlier tree's csrc: dA and dB sources
   with this tree's entry points; a WMMA forward ``gemm_fused.cu`` whose
   entry point takes no plan, or the TMA + wgmma one of PRs 16-21 (no
   layernorm, the gate meaning silu), and a two-pass ``flash_bwd.cu``,
   each where the tree has it; its ``flash_fwd.cu``, whose entry point is this
   tree's; its partials-only ``flash_decode.cu`` and
   ``flash_decode_paged.cu``, PR 18 and before, with their
   ``decode_split.cuh``; its ``rope.cu`` and ``fused_norm.cu``, whose
   entry points are this tree's), the earlier forward is timed in turns
   with this one at every forward shape whose chain it takes (a forward
   whose entry point is this tree's at every shape, saving no non-gated
   preact), the earlier dA + dB with this one's (a dA without
   the layernorm pass on the llama chains), the earlier flash forward with this one at its three shapes, the
   earlier flash backward with this one, the earlier decode kernels, each
   with the plain ``combine_splits`` after it, with these at their four
   shapes, and the earlier RoPE and fused norm kernels with these at every
   shape of theirs (baseline, new, new, baseline).
   No PyTorch call computes RoPE or the fused norm (no library time). The
   fused norm has a partial yardstick: ``F.layer_norm`` of the summed
   residual, which leaves out the dropout, the add and the residual output
   and so moves half the bytes.
4. The slice: llama-1b at full width with seeded random weights, 8 requests
   (prompts of 128-256 tokens, 32 new tokens, greedy) through
   ``RequestQueue(Engine(...), batch_size=4, buckets=(256,))`` in kernel
   mode; every kernel launch counter is zeroed just before and read just
   after, and must equal the launches the path makes. Decode steps replay
   from the ``("decode", 4)`` bucket's CUDA graph (captured in a warm-up
   batch); a replay adds the launches its capture recorded. The engine's
   ``bucket_lru`` is printed, and one replayed step from the cache it finds
   must equal an eager ``decode_step`` from a copy of that cache bit for
   bit (logits and cache), with the same launch counts. Then teacher forcing:
   the served token streams go through the kernel path, the plain bf16 path
   and the plain fp32 path; the kernel path's per-step logits must be no
   further from fp32 than 2x the plain bf16 path's distance + 1e-2.
5. The paged slice: ``PagedEngine`` in kernel mode. (a) Under pool
   pressure: 8 slots, page 64, 8 pages a sequence, a 33-page pool, 16
   requests (prompts of 96-320 tokens, 16-64 new tokens, greedy); at least
   one preemption. (b) The fast paths: ``prefix_cache=True`` and
   ``chunk_tokens=128``, 12 requests sharing a 192-token prefix plus 32-160
   tokens of their own; at least one prefix hit and one chunk. Each checks
   completion, prompts and lengths, the pool accounting, and that every
   kernel launch counter (zeroed just before, read just after) equals what
   the engine's own counters imply, decode steps replayed from the page
   buckets' CUDA graphs; ``bucket_lru`` printed, and one replay of the first
   cached decode bucket on a lone slot bit for bit the eager
   ``decode_step_paged``, as in phase 4. Then teacher forcing: two served
   streams per phase that were neither preempted nor prefix-matched are
   replayed through the same route in a lone slot; the replay's greedy
   tokens must equal the served ones exactly, and its logits must be no
   further from the fp32 plain path than 2x the plain bf16 path's distance
   + 1e-2.
6. Training. (a) Gradients at full width: llama-1b at 2 layers, one batch
   of 4 x 1024 tokens from the ported pipeline; the per-leaf grads of
   ``lm_loss`` in kernel mode (bf16), in reference mode (bf16) and in
   reference mode at fp32 (the truth): every leaf's kernel-mode error
   against the truth no larger than 2x the bf16 reference mode's + 1e-3.
   (b) All 16 layers of llama-1b trained through ``train_loop`` for 8
   steps of 4 x 1024 tokens (``cosine_schedule``, 2 warm-up steps,
   ``remat_policy="full"``) in kernel mode: every launch counter, zeroed
   just before and read just after, equals 8 steps of what the model
   implies (per layer and step 8 ``gemm_fused``, 4 GEMM-backward operand
   passes, 4 dA, 4 dB, 2 flash forward and 2 flash backward launches,
   the main kernel and the dq conversion); every loss finite and the last
   below the first; then the same 8 steps on the plain bf16 path and the
   plain fp32 path (the truth, same seed and data): the kernel curve no
   further from the truth than 2.5x the plain bf16 curve's distance +
   0.05. Prints tokens/s and step time (median of the steps after the
   first), the peak device memory and the device-busy share of one traced
   step.
7. The ladder's standalone-RoPE rungs and the fused norm op. (a) Phase 4's
   traffic served by a model built with ``qkv_plan="norm_fused"`` (the
   norm-prologue q|k and v GEMMs without the rope store, then the RoPE
   kernel): launches exact (32 ``rope`` per served batch), teacher-forced
   logits under phase 4's bound. (b) 3 steps of phase 6b's training on
   ``qkv_plan="norm_fused"`` (96 ``rope`` a step: forward, recompute,
   backward), the curve no further from 6b's fp32 curve over those steps
   than 2.5x the plain bf16 curve's distance + 0.05. (c) One teacher-forced
   pass of 7a's tokens with ``qkv_plan="unfused"`` (standalone norm, plain
   projections, the RoPE kernel) under the same bound. (d)
   ``dropout_residual_layernorm`` through the public op at the bench's
   shapes (fp32, and bf16 at 8192 rows): outputs against the plain
   version, and the kernel's keep-mask, read from a probe call with x = 1
   and residual = 0, bit for bit the plain version's.
8. The dense decoders of the registry at published width, seeded random
   weights rescaled to a trained model's scale (as 6a's), kernel mode, one
   at a time (freed before the next):
   granite-8b (all 36 layers), chatglm3-6b, minicpm-2b and qwen2-72b (4
   layers each). (a) Phase 4's traffic and checks through
   ``RequestQueue(Engine)``, batch 4, the fp32 truth at the same depth;
   (b) 8 requests of 128-256 tokens, 32 new ones, through
   ``PagedEngine(batch_slots=8, page_size=64, chunk_tokens=128)`` with
   phase 5's checks. Prints each config's decode tokens/s.
9. The encoder families at published width, weights at a trained
   model's scale (as 8's), kernel mode. (a) whisper-base whole (6 + 6
   layers) through ``Engine.generate``: batch 4, 64-token prompts, 32 new
   tokens, greedy, seeded ``encoder_embeds`` (4, 1500, 512) in
   ``extra_batch``; launches exact (per encoder layer 4 ``gemm_fused`` and
   a flash forward, per decoder layer 4 and 2 in the prefill and 2
   ``gemm_fused`` and 2 ``flash_decode`` a step); one replayed decode step
   bit for bit the eager one (logits, the self cache; the cross cache
   unchanged); teacher-forced logits under phase 4's bound. Prints the
   encode + prefill seconds and the decode tokens/s. (b) bert-110m whole
   (12 layers), its forward on 8 x 512 tokens: launches exact, logits
   under the same bound, tokens/s. (c) bert-110m whole trained through
   ``train_loop`` on 8 x 512 tokens a step, 15% of the positions masked to
   id 0 and the loss on those, and (d) whisper-base whole on 4 x 448
   target tokens over seeded ``encoder_embeds`` (4, 1500, 512); weights
   at a trained model's scale; each: one batch's per-leaf grads in kernel
   mode within 2x the plain bf16 path's distance from fp32 + 1e-3, 6 steps
   in each mode with every loss finite and the kernel curve within 2.5x
   the plain bf16 curve's distance from fp32 + 0.05, launches exact (per
   layer and step 8 ``gemm_fused``, 4 operand passes, 4 dA, 4 dB, and per
   attention 2 flash forwards and the flash backward's 2 launches; a
   whisper decoder layer has two attentions, its cross projections plain
   products), tokens/s, peak memory and one traced step's busy share.
10. Greedy speculative decoding: llama-1b whole, weights at a trained
   model's scale, kernel mode, ``PagedEngine(..., spec_tokens=4)``: (a)
   phase 5a's traffic and pool with the target drafting for itself (at
   least one preemption under a round's 4-token headroom), (b) the same
   with a layer-skip draft (the target's embedding, final norm and first 2
   blocks, views of its stacked leaves), (c) phase 5b's traffic with the
   prefix cache, 128-token chunks and the self-draft; the plain
   ``PagedEngine`` on the same weights and traffic beside each. First one
   served stream by 4-token verify steps against serial decode steps in a
   lone slot: whether their logits are equal bit for bit. Each phase
   checks completion and pool accounting; every stream equal to the plain
   engine's or, where one differs, the plain step's top-2 logit margin at
   its first differing position under the logit distance of the routes the
   two engines can take there (verify steps against serial steps, and a
   re-prefill for a preempted request); the self-draft accepting every
   proposal unless the routes' logits differ; every launch counter (zeroed
   just before, read just after) equal to what the engine's counters imply
   (per round k draft steps and one verify, each 2 ``gemm_fused`` and one
   ``flash_decode_paged`` a layer, plus both models' prefills and chunks);
   ``bucket_lru`` printed and the ``verify``, ``draft_decode`` and a draft
   prefill or chunk key cached; one replayed verify step bit for bit the
   eager T = 4 ``decode_step_paged``; decode tokens/s beside the plain
   engine's.
11. The trainer's leftovers, kernel mode at llama-1b's published width.
   (a) 6b's 16 layers, 8 steps, data and seed with ``ce_chunk=256`` (the
   cross entropy over 256-position chunks, each chunk's logits made under
   a checkpoint): launches exactly 6b's, the curve within 2.5x 6b's plain
   bf16 curve's distance from 6b's fp32 curve + 0.05 (the function is
   6b's); (b) the same with ``remat_policy="dots"`` (per layer and step 4
   ``gemm_fused``, their outputs kept, and 2 flash forwards) and then
   ``"none"`` (4 and 1), launches exact, curves under 6b's bound; each of
   (a) and (b) prints its step time and peak memory beside 6b's and one
   traced step's device ms by family. (c) 2 layers, 6 steps of
   ``train_loop`` with a checkpoint every 2 steps (keep 2) in a temporary
   directory (removed at the end; its free space printed first) and a
   failure injected at step 5: one restart, resumed at step 4, the
   checkpoint of step 4 bit for bit a copy of the state taken at its save
   (params, moments, count, step), the available steps as keep says, the
   losses after the restore within 1e-3 relative of an uninterrupted
   run's (the flash backward's dq order varies between runs), launches
   exact; prints the bytes written, each save's synchronous snapshot and
   background write seconds, and the step times that overlapped a write
   beside those that did not. (d) ``grad_compress=True`` at 2 layers, 6
   steps in kernel, plain bf16 and plain fp32 modes, each compressed: the
   kernel curve within 2.5x the plain bf16 curve's distance + 0.05 of the
   compressed fp32 curve, losses finite and falling, launches exact; the
   residuals' bytes and the step time beside (c)'s uncompressed run.
12. mixtral-8x7b at published width (d 4096, 32/8 heads, 8 experts top-2,
   d_ff 14336, window 4096) cut to 4 layers, weights at a trained model's
   scale, kernel mode beside the plain bf16 and fp32 paths: (a) phase 8a's
   traffic through ``RequestQueue(Engine)`` and (b) 8b's through
   ``PagedEngine``, with phases 4's and 5's checks (per layer 2 + 2E
   ``gemm_fused`` a prefill or chunk, 2E a decode step; a replayed decode
   step bit for bit the eager one); (c) two 4160-token prompts, 64 new
   tokens each, through ``Engine(max_len=4232)`` (a 4096-slot ring the
   prefill wraps) and through a ``PagedEngine`` of 67-page tables and
   128-token chunks: launches exact, the streams equal or apart where the
   Engine step's top-2 margin is under the two routes' logit distance,
   the logits within phase 4's bound. Every teacher-forced check of an
   MoE runs the plain paths on the kernel path's expert choices (a near
   tie flips under bf16 rounding, and a token served by other experts is
   no measure of rounding error); the fp32 router's disagreement with the
   kernel path's choices is printed and held under 10%. Prints tokens/s,
   the init time, the peak memory and the phase's seconds.
13. mixtral-8x7b trained at published width cut to 1 layer (1.71 B
   parameters; AdamW's fp32 state of 2 layers would fill the card),
   4 x 1024 tokens a step, remat "full", weights at a trained model's
   scale: (a) every leaf's grad of ``lm_loss`` (the load-balancing term
   included) in kernel mode within 2x the plain bf16 path's distance from
   the fp32 truth + 1e-3, the plain paths routed as the kernel path (the
   fp32 router's disagreement share printed, under 10%); (b) 4 steps of
   ``train_loop`` in kernel, plain bf16 and fp32 modes, the kernel curve
   within 2.5x the plain bf16 curve's distance + 0.05 of the fp32 curve,
   losses finite and falling; launches exact (per layer and step
   2 (2 + 2E) ``gemm_fused``, 2 + 2E each of the operand pass, dA and dB,
   2 flash forward, 2 flash backward), the median step after the first,
   the peak memory and one traced step's busy share.
14. Telemetry (``repro_torch.obs``): one 5a serving pass of llama-1b and
   one 6b training step, each under ``obs.capture(timing=True)``, between
   runs without a capture and one under an untimed capture (the capture's
   cost); every kernel's journal events equal its launch count less the
   launches CUDA graph replays added (a replay journals nothing); the
   engine's ``engine.*`` counters equal its attributes, the trainer's
   ``trainer.steps`` its steps; both exports pass ``tools/trace_check.py``
   (a subprocess); the summary is printed; the uncaptured 6b step with
   the backward on autograd's device thread against the calling thread,
   where ``loss_and_grads`` runs it, in turns.
15. recurrentgemma-2b at published width and all 26 layers (18 RG-LRU
   blocks and 8 local-attention blocks, head_dim 256, a 2048-token
   window), seeded weights (the tied embedding at a trained model's
   scale), kernel mode beside the plain bf16 and fp32 paths: (b) 8
   requests of 2100-2304 tokens, past the window, 32 new tokens each,
   through ``RequestQueue(Engine)`` at batch 4: launches exact by block
   kind (per 'rg' layer 2 ``gemm_fused`` a prefill or step; per 'local'
   layer 4 ``gemm_fused``, a flash forward and 2 RoPE a prefill, 2
   ``gemm_fused`` and a ``flash_decode`` a step), a replayed decode step
   bit for bit the eager one (rings and recurrent states too), the
   prefill and first decode logits within phase 4's bound of the fp32
   truth; (c) ``PagedEngine`` refusing a prefix cache, chunks and a draft
   on the recurrent stack, then 16 requests of 200-2300 tokens (none a
   page multiple) through 8 slots of 40 64-token pages, launches exact,
   a replayed step bit for bit, each stream against ``Engine.generate``
   of its prompt alone (equal, or apart where the Engine step's top-2
   margin is under the two routes' logit distance). Prints tokens/s, the
   init time, the peak memory and the phase's seconds.
16. recurrentgemma-2b trained at published width cut to 6 layers (two
   periods of ('rg', 'rg', 'local'), the stacked layout; 1.17 B
   parameters), 2 x 4096 tokens a step, past the 2048-token window,
   seeded weights at a trained model's scale (``trained_scale``, the tied
   embedding's over d_model). (a) With phase 3: the flash backward at
   head_dim 256 at that shape (10 query heads over one kv head, causal in
   the window) and at B 4, S 1024 with no window, held as phase 3's
   flash-backward rows, timed whole and as its main kernel, delta,
   zeroing and conversion, beside its bound and SDPA's backward (the
   window as a mask); the forward GEMM and the GEMM backward at its four
   training GEMMs (M 8192); RoPE at its q and k (rung 2) and the
   backward at its q. (b) Per-leaf grads of ``lm_loss`` in kernel mode
   within 2x the plain bf16 path's distance from fp32 + 1e-3 (phase 6a's
   bound).
   (c) 8 steps of ``train_loop`` in kernel mode beside the plain bf16 and
   fp32 curves, held to 2.5x + 0.05; launches exact by block kind (per
   'rg' layer and step 4 ``gemm_fused`` and 2 of each GEMM-backward
   launch; per 'local' layer 8 ``gemm_fused``, 4 of each GEMM-backward
   launch, 2 flash forward, 2 flash backward and 6 RoPE). Prints
   tokens/s (the median step after the first), the peak memory and a
   traced step's busy share and device ms by kernel family.
17. mamba2-130m served whole (24 layers of the SSD block, no attention and
   no MLP; d 768, 24 heads of 64, d_state 128, chunk 128), seeded weights
   at a trained model's scale with Mamba2's published decay and time-step
   draws. The block is plain torch, as the reference's: no kernel
   launches, and kernel and reference mode are one path, so its bf16
   numbers are held to fixed bounds from fp32 (``PLAIN_LOGIT_SHARE``,
   ``PLAIN_GRAD_SHARE``, ``PLAIN_CURVE_BOUND``) and no plain run repeats
   the kernel run. (a) The logits of 2 x 2048 tokens and a prefill + 8
   decode steps on the kernel path within 0.1 of the fp32 logits' max
   from fp32, the fp32 decode steps within 1e-3 of it from the fp32
   forward.
   (b) ``RequestQueue(Engine)`` at batch 4 over 4 prompts each of 1531 and
   4011 tokens (one bucket per length: no left pad runs through the
   state), 64 new tokens; a replayed decode step bit for bit the eager
   one; prefill and decode tokens/s. (c) ``PagedEngine``'s three refusals,
   then (b)'s 8 prompts and 8 more of 200-4000 tokens (none a page
   multiple) through 8 slots over a 100-page pool that forces
   preemptions: the streams of (b)'s prompts equal to (b)'s or apart
   where the Engine step's top-2 margin is under the two routes' logit
   distance (the paged route replayed from its last exact prefill: the
   prompt's or a preemption's re-prefill).
   (d) One prompt of 524,288 tokens (the reference's long_500k) through
   ``Engine`` at batch 1 and 32 decode steps: prefill seconds and tokens/s,
   the peak memory, the decode cache's bytes equal to a 4096-token
   prompt's; the last position's logits of a kernel-path prefill within
   0.1 of the logits' max of an fp32 prefill of the same prompt.
18. mamba2-130m trained whole on 8 x 4096 tokens, remat 'full': (a)
   per-leaf grads within 0.25 of the fp32 leaf's largest entry, (b) 8
   steps, no kernel launches, every loss finite and the last below the
   first, the curve within 0.05 of the fp32 curve; tokens/s, the peak and
   a traced step's busy share and device ms by family.
19. internvl2-2b (24 layers, d 2048, 16 heads of 128 over 8 kv heads,
   d_ff 8192, vocab 92,553, 256 patch embeddings in front of the text).
   (a) ``vlm_forward`` at full depth on 2 x (256 + 512) positions against
   fp32, launches exact. (b) Text-only serving on the backbone, as the
   reference's: ``RequestQueue(Engine)`` over 4 prompts each of 700 and
   1211 tokens and the same requests through ``PagedEngine``, launches
   exact, streams equal across the engines (or apart under (17c)'s rule).
   (c) Trained at 24 layers on 4 x 2048 positions (256 patches + 1792
   text tokens): per-leaf grads against fp32 (phase 6a's bound), 8 steps
   in kernel mode (launches exact) beside the plain bf16 and fp32 curves
   (phase 16c's bound), tokens/s, the peak (held under 75 GB) and a
   traced step. (d) With phase 3: ``gemm_fused`` and the GEMM backward at its
   four training GEMMs (M 8192), the flash forward and backward at B 4,
   H 16, Hkv 8, S 2048, d 128 causal, and the paged decode at d 128.
20. llama4-maverick-400b-a17b at published width (d 5120, 40 heads over 8,
   a GQA group of 5, head_dim 128, d_ff 8192, vocab 202,048, 128 experts
   top-1) cut to 2 layers: one ('attn', 'moe') group, the published
   ``blocks_0``/``blocks_1`` layout, 36.9 GB of bf16 weights (each leaf
   cast as it is drawn) at a trained model's scale; the fp32 truth reads
   the experts,
   the embedding and the head from the bf16 copy, upcast where the plain
   path reaches them (one expert at a time), so no fp32 copy of the
   experts exists. (a) Phase 8a's traffic through ``RequestQueue(Engine)``
   and (b) 8b's through ``PagedEngine`` (128-token chunks), with phases
   4's and 5's checks: launches exact (per prefill or chunk 4
   ``gemm_fused`` in the dense layer and 2 + 2 x 128 in the MoE layer;
   per decode step 2 and 256), a replayed decode step bit for bit the
   eager one, the logits under phase 4's bound on the kernel path's
   routing, the fp32 router's disagreement share printed and under 10%;
   (c) 8b's requests through ``ShardedPagedEngine(n_hosts=2)`` over the
   one weight copy: launches exact, the placements and admissions by
   host the least-loaded rule's, each host's streams token for token a
   lone ``PagedEngine``'s fed the requests placed on it. With phase 3:
   the forward GEMM at its q|k + rope (K 5120, N 6144) and an expert's up
   (2 x N 8192) and down (K 8192) at M 1024 and M 4, the flash forward at
   B 4, H 40, Hkv 8, S 256, ``flash_decode`` at G 5 and
   ``flash_decode_paged`` at G 5 (decode, a 128-token chunk, verify
   steps of 4 and 5 tokens, each verify row bit for bit the serial step).
   Prints tokens/s, the peak memory and the phase's seconds.
21. The distributed layer over one NCCL rank: (a) phase 20's weights
   served through ``moe_ep``, (b) mixtral through ``moe_tp``, (c) the ring
   GEMM, (d) llama-1b's ZeRO-1 split step against the single-device one
   and a sharded checkpoint of llama-1b at 2 layers restored bit for bit.
22. Tensor-parallel training: (a) mixtral at 1 layer through both impls;
   (b, with phase 3) the kernels at the ranks' shapes over extents 2, 4.
23. The other families' split step: (a) bert-110m and whisper-base whole,
   internvl2-2b at 2 layers, recurrentgemma-2b at 3, mamba2-130m at 4,
   each at published width, 5 steps split at a 'model' extent of 1
   against the single-device step (plain bf16 bit for bit, kernel mode
   within 2 x two single runs' spread + 0.01, 0 'model' collectives,
   launches equal, step times); (b, with phase 3) their GEMMs and flash
   kernels at the ranks' shapes over extents 2 and 4, and the RG-LRU's
   plain products at the rank's width.
24. The policy layer (``repro_torch.core``): (a) at three of phase 3's
   prefill shapes (one split) every GEMM candidate the calibration times
   (each tile width x walk window) held to the plain version, and at each
   width the forward's, dA's and dB's outputs across windows 1, 4, 8 and
   16 bit for bit; (b) ``launch/calibrate.py --smoke`` on the card (its
   exit code, the drift gate's verdict, recorded with the violations), the
   shipped ``configs/pretuned/h100.json`` and then its table installed:
   the cells' hits, both engines' ``bucket_policies``
   the table's pins; (c) llama-1b (POLICY_LAYERS layers of published
   width) served by both engines with ``qkv_plan="auto"``, its greedy
   streams equal to the pinned rung's where auto took that rung,
   ``train_loop(pretuned=)`` for 3 steps over two batch shapes
   (``trainer.bucket_pins`` 2), one mixtral-8x7b layer at published width
   under "auto" against the fused default; (d) ``gemm_collective(plan=
   None)`` and ``bwd_mode="auto"`` on one NCCL rank, each bit for bit the
   plan or mode the autotuner names.
25. One JSON line of per-kernel numbers, the nvidia-smi line, and the last
   line ``{"ok": true, "device": {...}}``.

``--out DIR`` also writes the full report to ``DIR/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import kernels, obs  # noqa: E402
from repro_torch.configs import get_config, load_shipped_pretuned  # noqa: E402
from repro_torch.core import autotune  # noqa: E402
from repro_torch.core.calibrate import Timer  # noqa: E402
from repro_torch.core.policy import gemm_policy  # noqa: E402
from repro_torch.data import DataConfig, DataIterator  # noqa: E402
from repro_torch.distributed.tensor_parallel import (  # noqa: E402
    TensorParallel)
from repro_torch.kernels.attention import (  # noqa: E402
    BLOCK_KV, combine_splits, decode_partials_paged_ref, decode_partials_ref,
    flash_attention_bwd_ref, flash_attention_fwd, flash_attention_fwd_ref,
    flash_decode, flash_decode_paged)
from repro_torch.kernels.attention import backward as attn_bwd  # noqa: E402
from repro_torch.kernels.attention import decode as attn_decode  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.attention.ref import ring_positions  # noqa: E402
from repro_torch.kernels.gemm import (EPILOGUE_NONE, PROLOGUE_NONE,  # noqa: E402
                                      Epilogue, Prologue, ln_rows_ref,
                                      rms_rows_ref)
from repro_torch.kernels.gemm import backward as gemm_bwd  # noqa: E402
from repro_torch.kernels.gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.gemm.ops import _forward as gemm_forward  # noqa: E402
from repro_torch.kernels.fused_norm import (  # noqa: E402
    dropout_keep_mask_ref, dropout_residual_layernorm,
    fused_dropout_residual_layernorm_ref)
from repro_torch.kernels.rope import (rope_launch, rope_ref,  # noqa: E402
                                      rope_tables)
from repro_torch.launch.profile_train import profile_step  # noqa: E402
from repro_torch.models import build_model, make_batch  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.common import nest, tree_map  # noqa: E402
from repro_torch.models.lm import layer_slots  # noqa: E402
from repro_torch.optim import AdamWConfig, cosine_schedule  # noqa: E402
from repro_torch.optim.optimizer import leaves, named_leaves  # noqa: E402
from repro_torch.serve import (Engine, PagedEngine, Request,  # noqa: E402
                               RequestQueue, ShardedPagedEngine)
from repro_torch.serve import kv_cache as kvc  # noqa: E402
from repro_torch.kernels.gemm.collective import (  # noqa: E402
    gemm_collective_oracle, gemm_collective_sharded, panel_plan)
from repro_torch.train import (FailureInjector, StragglerWatchdog,  # noqa: E402
                               init_state, loss_and_grads, make_train_step,
                               train_loop)
from repro_torch.train.state import (sharded_init,  # noqa: E402
                                     state_shardings)
from repro_torch.train import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.train import trainer as trainer_mod  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense)
PEAK_BF16 = 989e12
HBM_BYTES_S = 3.35e12

BATCH, PROMPT, NEW_TOKENS, REQUESTS = 4, 256, 32, 8
MAX_LEN = PROMPT + NEW_TOKENS + 8          # as the serving launcher sizes it
# phase 9a: whisper-base through Engine.generate; 9b: bert-110m's forward
W_BATCH, W_PROMPT, W_NEW = 4, 64, 32
W_MAX_LEN = W_PROMPT + W_NEW + 8
B_BATCH, B_SEQ = 8, 512
# phases 9c, 9d: bert-110m trained on B_BATCH x B_SEQ tokens, 15% of them
# masked; whisper-base on W_TRAIN_BATCH x W_TRAIN_SEQ target tokens over
# 1500 frames; steps of each
W_TRAIN_BATCH, W_TRAIN_SEQ, ENC_TRAIN_STEPS, MLM_MASK = 4, 448, 6, 0.15
# the paged slice: PagedEngine geometry and the chunk of phase 5b
SLOTS, PAGE, MAX_PAGES, CHUNK = 8, 64, 8, 128
# phase 10: tokens a speculative round verifies (k), the layer-skip draft's
# depth
SPEC_TOKENS, SKIP_LAYERS = 4, 2
# the training slice: batch x sequence a step, steps, peak learning rate
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 1024, 8, 1e-3
# phase 7b: steps of 6b's run on the ladder's rung 2
LADDER_STEPS = 3
# phase 11: the chunk of 11a's cross entropy; 11c's and 11d's depth, steps,
# checkpoint interval and kept checkpoints, the step the injected failure
# stops and the step it resumes from
CE_CHUNK = 256
SHORT_LAYERS, SHORT_STEPS, CKPT_EVERY, CKPT_KEEP = 2, 6, 2, 2
CKPT_FAIL, CKPT_RESUME = 5, 4
# phase 12: mixtral-8x7b cut to MOE_LAYERS layers (its 32 are ~93 GB in
# bf16, more than one card holds); 12c: WIN_BATCH prompts of WIN_PROMPT
# tokens (65 pages, past the 4096-token window) with WIN_NEW new tokens
# each, over WIN_PAGES-page tables
MOE_ARCH, MOE_LAYERS = "mixtral-8x7b", 4
WIN_BATCH, WIN_PROMPT, WIN_NEW, WIN_PAGES = 2, 4160, 64, 67
MOE_PHASES = ("12a", "12b", "12c engine", "12c paged")
# phase 13: mixtral-8x7b trained, cut to MOE_TRAIN_LAYERS layers (AdamW's
# peak of fp32 masters, m, v, grads and the update's temporaries is about
# 24 bytes a parameter: 41 GB at 1 layer, 76 GB at 2), MOE_TRAIN_STEPS steps
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 1, 4
# the phases whose launches are phase 13's path (13a only checks grads)
MOE_TRAIN_PHASES = ("13b",)
# phase 14: the captured serving pass and training step
TELEMETRY_PHASES = ("14 serve", "14 train")
# phase 15: recurrentgemma-2b whole (26 layers, 5.8 GB in bf16; its fp32
# truth beside it). 15b: RG_REQUESTS requests of RG_SHORTEST to RG_PROMPT
# tokens (past the 2048-token local window), RG_BATCH a batch, RG_NEW new
# tokens; 15c: RG_PAGED requests of RG_PAGED_LENS tokens through SLOTS
# slots of RG_PAGES-page tables
RG_ARCH = "recurrentgemma-2b"
RG_BATCH, RG_PROMPT, RG_NEW, RG_REQUESTS = 4, 2304, 32, 8
RG_SHORTEST = 2100
RG_PAGED, RG_PAGES, RG_PAGED_LENS = 16, 40, (200, 2300)
RG_PHASES = ("15b", "15c")
# phase 16: recurrentgemma-2b trained at published width, cut to
# RG_TRAIN_LAYERS layers (two periods of its pattern, so the stacked
# blocks_{i} layout: 1.17 B parameters, ~28 GB of AdamW state at ~24 bytes
# a parameter; its 26 layers are 2.89 B, ~69.5 GB), RG_TRAIN_BATCH x
# RG_TRAIN_SEQ tokens a step (past the 2048-token window), TRAIN_STEPS steps
RG_TRAIN_LAYERS, RG_TRAIN_BATCH, RG_TRAIN_SEQ = 6, 2, 4096
# the phases whose launches are phase 16's path (16b only checks grads)
RG_TRAIN_PHASES = ("16c",)
# phase 17: mamba2-130m whole (24 layers, 0.26 GB in bf16). 17a: the
# logits of M2_CHECK_BATCH x M2_CHECK_PROMPT tokens, the last M2_CHECK_STEPS
# of them also as decode steps; 17b: 4 prompts of each of M2_LENS tokens
# (each length its own bucket: no left pad runs through the state), M2_NEW
# new tokens; 17c: M2_PAGED requests (17b's and more of M2_PAGED_LENS
# tokens) through SLOTS slots of M2_PAGES-page tables over a pool of
# M2_POOL pages, too few for every slot's pages at once; 17d: one prompt of
# LONG_PROMPT tokens (the reference's long_500k shape), LONG_STEPS decode
# steps
M2_ARCH = "mamba2-130m"
M2_CHECK_BATCH, M2_CHECK_PROMPT, M2_CHECK_STEPS = 2, 2048, 8
M2_LENS, M2_NEW = (1531, 4011), 64
M2_PAGED, M2_PAGED_LENS, M2_PAGES, M2_POOL = 16, (200, 4000), 64, 100
LONG_PROMPT, LONG_STEPS = 524288, 32
M2_PHASES = ("17b", "17c", "17d")
# phase 18: mamba2-130m trained whole, M2_TRAIN_BATCH x M2_TRAIN_SEQ tokens
M2_TRAIN_BATCH, M2_TRAIN_SEQ = 8, 4096
M2_TRAIN_PHASES = ("18b",)
# a path that launches no kernel (mamba2's: its SSD blocks are plain, as
# the reference's) has a kernel path equal to its plain bf16 path, so its
# bf16 numbers are held to fixed bounds from the fp32 truth, about twice
# the largest distance read on the card (PERF.md section 4): the logits
# within PLAIN_LOGIT_SHARE of the fp32 logits' max, each grad within
# PLAIN_GRAD_SHARE of its fp32 leaf's largest entry, the loss curve within
# PLAIN_CURVE_BOUND of the fp32 curve
PLAIN_LOGIT_SHARE, PLAIN_GRAD_SHARE, PLAIN_CURVE_BOUND = 0.1, 0.25, 0.05
# phase 19: internvl2-2b (1.89 B parameters, 3.8 GB in bf16). 19a: 2 x (256
# patches + IVL_CHECK_TEXT text tokens); 19b: 4 prompts of each of IVL_LENS
# tokens, IVL_NEW new tokens, both engines (IVL_PAGES-page tables); 19c:
# trained at IVL_TRAIN_LAYERS layers on IVL_TRAIN_BATCH x IVL_TRAIN_SEQ
# positions (256 patches + the text; AdamW's ~24 bytes a parameter are
# ~45 GB at 24 layers)
IVL_ARCH = "internvl2-2b"
IVL_CHECK_TEXT = 512
IVL_LENS, IVL_NEW, IVL_PAGES = (700, 1211), 32, 32
IVL_TRAIN_LAYERS, IVL_TRAIN_BATCH, IVL_TRAIN_SEQ = 24, 4, 2048
IVL_PHASES = ("19b engine", "19b paged", "19c")
# phase 20: llama4-maverick-400b-a17b at published width (d 5120, 40/8
# heads, d_ff 8192, vocab 202,048, 128 experts top-1) cut to MAV_LAYERS
# layers: one ('attn', 'moe') group, the published blocks_0/blocks_1
# layout. In bf16 its experts are 32.2 GB and its untied embedding and head
# 4.1 GB; the fp32 truth keeps those leaves in bf16 and upcasts them where
# the plain path reaches them (``kept_in_bf16``), where a whole fp32 copy
# (64.4 GB of experts) would not fit beside them. 20a and 20b take
# phase 8's traffic; 20c 20b's requests over MAV_HOSTS hosts
MAV_ARCH, MAV_LAYERS, MAV_HOSTS = "llama4-maverick-400b-a17b", 2, 2
MAV_PHASES = ("20a", "20b", "20c")
# the largest share of token-layer expert choices on which the fp32
# router, along the kernel path's teacher-forced run, may pick another
# expert set than the kernel path (near ties flip under bf16 rounding; a
# router fed the wrong tokens would reroute most of them)
MAX_REROUTED = 0.1
# phase 21: the distributed layer over one NCCL rank. 21a serves 20a's
# traffic on phase 20's weights through moe_ep; 21b mixtral-8x7b at
# TP_LAYERS layers of published width through moe_tp (a forward over
# BATCH x PROMPT tokens, a prefill and TP_DECODE decode steps); 21c the
# collective GEMM at llama-1b's prefill down projection (COLL_SHAPE: M,
# K, N); 21d llama-1b's training at phase 6b's shape, DIST_STEPS steps
DIST_PHASES = ("21a", "21b", "21c", "21d")
TP_ARCH, TP_LAYERS, TP_DECODE = "mixtral-8x7b", 1, 8
COLL_SHAPE = (BATCH * PROMPT, 8192, 2048)
DIST_STEPS = 4
# 21d's checkpoint: llama-1b cut to this depth (the whole model's 19.6 GB
# took 126 s to save and restore)
DIST_CKPT_LAYERS = 2
# phase 22: tensor-parallel training over one NCCL rank. 22a trains
# mixtral-8x7b at MOE_TRAIN_LAYERS layer(s) of published width through
# moe_ep and moe_tp, TP_TRAIN_STEPS steps each; 22b times phase 3's
# training GEMMs and flash kernels of llama-1b and mixtral at a rank's
# shapes over 'model' extents TP_EXTENTS
TP_TRAIN_PHASES = ("22a ep", "22a tp")
TP_TRAIN_STEPS = 3
TP_EXTENTS = (2, 4)
# phase 23: the other families' split step over one NCCL rank. 23a trains
# each arch at published width, TPF_LAYERS layers (None: whole), TPF_STEPS
# steps of TPF_BATCH x TPF_SEQ tokens, split at a 'model' extent of 1
# against the single-device step; 23b times phase 3's training rows at
# their ranks' shapes over TP_EXTENTS
TPF_LAYERS = {"bert-110m": None, "whisper-base": None, "internvl2-2b": 2,
              "recurrentgemma-2b": 3, "mamba2-130m": 4}
TPF_PHASES = tuple(f"23a {arch}" for arch in TPF_LAYERS)
TPF_BATCH, TPF_SEQ, TPF_STEPS = 2, 1024, 5
# the memory-bound bench's fused-norm cells (benchmarks/bench_memory_bound.py)
NORM_ROWS, NORM_D, NORM_P, NORM_SEED = (2048, 4096, 8192), 2048, 0.1, 7

SOURCES = {
    "gemm_fused": ("src/repro_torch/kernels/csrc/gemm_fused.cu",
                   "src/repro/kernels/gemm/kernel.py:84"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_fwd.cu",
                            "src/repro/kernels/attention/kernel_fwd.py:45"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/attention/kernel_decode.py:109"),
    "flash_decode_paged": ("src/repro_torch/kernels/csrc/flash_decode_paged.cu",
                           "src/repro/kernels/attention/kernel_decode.py:132"),
    # the transposed epilogue of _da_kernel (:73) and _db_kernel, A's norm
    "gemm_bwd_g": ("src/repro_torch/kernels/csrc/gemm_bwd_g.cu",
                   "src/repro/kernels/gemm/backward.py:73"),
    "gemm_bwd_da": ("src/repro_torch/kernels/csrc/gemm_bwd_da.cu",
                    "src/repro/kernels/gemm/backward.py:63"),
    "gemm_bwd_db": ("src/repro_torch/kernels/csrc/gemm_bwd_db.cu",
                    "src/repro/kernels/gemm/backward.py:226"),
    # one kernel for _dq_kernel (:71) and _dkv_kernel (:114)
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_bwd.cu",
                            "src/repro/kernels/attention/kernel_bwd.py:71"),
    "rope": ("src/repro_torch/kernels/csrc/rope.cu",
             "src/repro/kernels/rope/kernel.py:28"),
    "fused_norm": ("src/repro_torch/kernels/csrc/fused_norm.cu",
                   "src/repro/kernels/fused_norm/kernel.py:43"),
}
# the phases whose launches are the main path's (6a only checks grads)
MAIN_PATH_PHASES = ("4", "5a", "5b", "6b", "7a", "7b", "7c", "7d")
# phase 11: the training leftovers
LEFTOVER_PHASES = ("11a", "11b dots", "11b none", "11c", "11d")
# phase 8: (arch, layers), granite-8b whole, the others cut in depth
# (qwen2-72b's 80 layers are ~145 GB in bf16, more than one card holds)
DENSE = (("granite-8b", 36), ("chatglm3-6b", 4), ("minicpm-2b", 4),
         ("qwen2-72b", 4))
DENSE_PHASES = tuple(f"8{p} {arch}" for arch, _ in DENSE for p in "ab")
# phase 9: whisper-base served (a), bert-110m's forward (b), bert-110m (c)
# and whisper-base (d) trained
ENCODER_PHASES = ("9a", "9b", "9c", "9d")


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA.16816", "WARPGROUP.DEPBAR")


def sass_counts(lib) -> dict:
    """How many times each of SASS_OPS appears in a library's machine code
    (``cuobjdump -sass``, beside nvcc): wgmma, TMA loads, mma.sync (the
    decode kernels' products), and the waits for wgmma groups."""
    from repro_torch.kernels._build import nvcc_path
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return {op: text.count(op) for op in SASS_OPS}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(bytes_: float, *work) -> tuple:
    """(ms, 'bytes' or 'operations'): the larger of the bytes over the
    memory rate and the operations over their peaks; ``work`` is pairs
    (flops, peak FLOP/s)."""
    t_ops = sum(flops / peak for flops, peak in work) * 1e3
    t_bytes = bytes_ / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_close(name, got, want, rtol, atol_frac):
    """Elementwise |got - want| <= rtol |want| + atol_frac * rms(want)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    atol = atol_frac * want.pow(2).mean().sqrt().item()
    err = (got - want).abs()
    bad = err > rtol * want.abs() + atol
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside "
            f"rtol {rtol} + atol {atol:.3g}; max abs err {err.max().item():.4g}")
    return err.max().item(), f"rtol {rtol:g} + {atol_frac:g} x rms"


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version at the main-path shapes
# ---------------------------------------------------------------------------

def gemm_cases(cfg, dev, gen):
    """One layer's gemm_fused launches: prefill q|k (+rope), v, SwiGLU up and
    down (residual, scale); decode up and down; q|k without rope (rung 2 of
    the QKV ladder); and the training forward's four at M = 4 x 1024, the
    SwiGLU up projection saving its preacts as the autograd forward does.
    (name, a, b, kwargs, save_preact)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    nqk = (cfg.num_heads + cfg.num_kv_heads) * hd
    nv = cfg.num_kv_heads * hd
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)

    gamma = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(bf16)
    rms = dict(prologue=Prologue(norm="rmsnorm"), gamma=gamma)
    m = BATCH * PROMPT
    pos = torch.arange(PROMPT, device=dev)
    sin, cos = rope_tables(pos, hd, cfg.rope_theta)
    sin, cos = sin.repeat(BATCH, 1), cos.repeat(BATCH, 1)
    wd = d ** -0.5
    wf = f ** -0.5
    x_pre, x_dec = rnd(m, d), rnd(BATCH, d)
    w_gate, w_in, w_out = rnd(d, f, std=wd), rnd(d, f, std=wd), rnd(f, d, std=wf)
    gate_ep = Epilogue(activation="silu", gate=True)
    res_ep = Epilogue(residual=True, scale=True)
    cases = [
        ("prefill_qk_rope", x_pre, rnd(d, nqk, std=wd),
         dict(epilogue=Epilogue(rope=True, head_dim=hd), sin=sin, cos=cos,
              **rms)),
        ("prefill_v", x_pre, rnd(d, nv, std=wd), dict(**rms)),
        ("prefill_up", x_pre, w_gate, dict(epilogue=gate_ep, b2=w_in, **rms)),
        ("prefill_down", rnd(m, f), w_out,
         dict(epilogue=res_ep, residual=rnd(m, d), scale=1.0)),
        ("decode_up", x_dec, w_gate, dict(epilogue=gate_ep, b2=w_in, **rms)),
        ("decode_down", rnd(BATCH, f), w_out,
         dict(epilogue=res_ep, residual=rnd(BATCH, d), scale=1.0)),
    ]
    # the ladder's rung 2 (phase 7): the same q|k GEMM without the rope store
    cases.append(("prefill_qk", x_pre, cases[0][2], dict(**rms)))
    cases = [(*c, False) for c in cases]
    for name, a, b, kw in train_gemm_cases(cfg, dev, gen)[:4]:
        cases.append((f"train_{name}", a, b, kw, "b2" in kw))
    return cases


# whisper-base's and bert-110m's gemm_fused launches (phase 9): name ->
# (M, K, N, prologue, epilogue kwargs). Whisper: the encoder over 4 x 1500
# frames, the decoder's prefill of 4 x 64 tokens, a decode step of 4; the
# gated gelu (geglu) at the encoder's shape is no whisper chain (its MLP is
# gelu), timed for the chain. Bert: 8 x 512 tokens.
ENCODER_GEMMS = {
    "whisper_enc_qk": (6000, 512, 1024, "ln_beta", {}),
    "whisper_enc_v": (6000, 512, 512, "ln_beta", {}),
    "whisper_enc_up_gelu": (6000, 512, 2048, "ln_beta",
                            dict(activation="gelu")),
    "whisper_enc_down": (6000, 2048, 512, None,
                         dict(residual=True, scale=True)),
    "whisper_dec_qk": (256, 512, 1024, "ln_beta", {}),
    "whisper_dec_up_gelu": (256, 512, 2048, "ln_beta",
                            dict(activation="gelu")),
    "whisper_decode_up_gelu": (4, 512, 2048, "ln_beta",
                               dict(activation="gelu")),
    "whisper_decode_down": (4, 2048, 512, None,
                            dict(residual=True, scale=True)),
    "geglu_up": (6000, 512, 2048, "ln", dict(activation="gelu", gate=True)),
    "bert_qk": (4096, 768, 1536, "ln_beta", {}),
    "bert_v": (4096, 768, 768, "ln_beta", {}),
    "bert_up_gelu": (4096, 768, 3072, "ln_beta", dict(activation="gelu")),
    "bert_down": (4096, 3072, 768, None, dict(residual=True, scale=True)),
}


# the training forward's launches that save their non-gated preact (phases
# 9c, 9d), timed again with the save
ENCODER_SAVES = ("whisper_enc_up_gelu", "bert_up_gelu")


def encoder_gemm_cases(dev, gen):
    """ENCODER_GEMMS as (name, a, b, kwargs, save_preact): the weights at
    std K^-1/2, gamma about 1, beta at std 0.5; then the ENCODER_SAVES
    launches again, saving their preact as the autograd forward does."""
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)

    cases = []
    for name, (m, k, n, norm, ep_kw) in ENCODER_GEMMS.items():
        kw = {"epilogue": Epilogue(**ep_kw)}
        if norm:
            kw.update(prologue=Prologue(norm="layernorm",
                                        beta=norm == "ln_beta"),
                      gamma=(1 + 0.1 * torch.randn(
                          k, generator=gen, device=dev)).to(bf16))
            if norm == "ln_beta":
                kw["beta"] = rnd(k, std=0.5)
        if ep_kw.get("gate"):
            kw["b2"] = rnd(k, n, std=k ** -0.5)
        if ep_kw.get("residual"):
            kw.update(residual=rnd(m, n), scale=1.0)
        cases.append((name, rnd(m, k), rnd(k, n, std=k ** -0.5), kw, False))
    cases += [(f"{name}_saved", a, b, kw, True)
              for name, a, b, kw, _ in cases if name in ENCODER_SAVES]
    return cases


def moe_gemm_cases(dev, gen):
    """mixtral-8x7b's gemm_fused launches (phase 12) as (name, a, b,
    kwargs, save_preact): the prefill's q|k (+ rope, head_dim 128) and v
    on the rmsnorm prologue at M = BATCH x PROMPT; an expert's dual-output
    silu-gated up projection with no prologue and its down projection with
    no epilogue, at M = BATCH x PROMPT and at a decode step's M = BATCH
    (split over K). The weights at std K^-1/2."""
    cfg = get_config(MOE_ARCH)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)

    rms = dict(prologue=Prologue(norm="rmsnorm"),
               gamma=(1 + 0.1 * torch.randn(d, generator=gen,
                                            device=dev)).to(bf16))
    m = BATCH * PROMPT
    sin, cos = rope_tables(torch.arange(PROMPT, device=dev), hd,
                           cfg.rope_theta)
    sin, cos = sin.repeat(BATCH, 1), cos.repeat(BATCH, 1)
    x = rnd(m, d)
    w_gate, w_in, w_out = (rnd(d, f, std=d ** -0.5), rnd(d, f, std=d ** -0.5),
                           rnd(f, d, std=f ** -0.5))
    up = dict(epilogue=Epilogue(activation="silu", gate=True), b2=w_in)
    cases = [
        ("mixtral_prefill_qk_rope", x,
         rnd(d, (cfg.num_heads + cfg.num_kv_heads) * hd, std=d ** -0.5),
         dict(epilogue=Epilogue(rope=True, head_dim=hd), sin=sin, cos=cos,
              **rms)),
        ("mixtral_prefill_v", x, rnd(d, cfg.num_kv_heads * hd, std=d ** -0.5),
         dict(**rms)),
        ("mixtral_expert_up", x, w_gate, dict(up)),
        ("mixtral_expert_down", rnd(m, f), w_out, {}),
        ("mixtral_decode_expert_up", rnd(BATCH, d), w_gate, dict(up)),
        ("mixtral_decode_expert_down", rnd(BATCH, f), w_out, {}),
    ]
    return [(*c, False) for c in cases]


def rg_gemm_cases(dev, gen):
    """recurrentgemma-2b's gemm_fused launches (phase 15) as (name, a, b,
    kwargs, save_preact): a local block's q|k (N 2816, head_dim 256: the
    rope store cannot hold a head, so no rope, rung 2) and v (N 256) on
    the rmsnorm prologue, every block's geglu up (2 x N 7680, the gated
    gelu store) on it and its down (K 7680) with the residual store, at
    M = RG_BATCH x RG_PROMPT, at phase 16's training M = RG_TRAIN_BATCH x
    RG_TRAIN_SEQ (the up saving its two preacts, as the training forward
    does) and at a decode step's M = RG_BATCH (where the path runs the up
    and down; its q|k and v are plain products). The weights at std
    K^-1/2."""
    cfg = get_config(RG_ARCH)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)

    rms = dict(prologue=Prologue(norm="rmsnorm"),
               gamma=(1 + 0.1 * torch.randn(d, generator=gen,
                                            device=dev)).to(bf16))
    w_qk = rnd(d, (cfg.num_heads + cfg.num_kv_heads) * hd, std=d ** -0.5)
    w_v = rnd(d, cfg.num_kv_heads * hd, std=d ** -0.5)
    w_gate, w_in, w_out = (rnd(d, f, std=d ** -0.5), rnd(d, f, std=d ** -0.5),
                           rnd(f, d, std=f ** -0.5))
    up = dict(epilogue=Epilogue(activation="gelu", gate=True), b2=w_in, **rms)
    res = Epilogue(residual=True, scale=True)
    cases = []
    for tag, m in (("prefill", RG_BATCH * RG_PROMPT),
                   ("train", RG_TRAIN_BATCH * RG_TRAIN_SEQ),
                   ("decode", RG_BATCH)):
        x = rnd(m, d)
        cases += [
            (f"rg_{tag}_qk", x, w_qk, dict(**rms), False),
            (f"rg_{tag}_v", x, w_v, dict(**rms), False),
            (f"rg_{tag}_up_geglu", x, w_gate, dict(up), tag == "train"),
            (f"rg_{tag}_down", rnd(m, f), w_out,
             dict(epilogue=res, residual=rnd(m, d), scale=1.0), False)]
    return cases


def verify_gemm_cases(cfg, dev, gen):
    """llama-1b's four fused GEMMs of a layer at the verify step's M =
    SLOTS x SPEC_TOKENS rows (q|k + rope and v behind the rmsnorm prologue,
    the SwiGLU up, the down projection + residual). The engine's verify
    runs the up and down ones (its q|k and v are plain products, as in
    every decode step). (name, a, b, kwargs, on the verify path)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    nqk = (cfg.num_heads + cfg.num_kv_heads) * hd
    nv = cfg.num_kv_heads * hd
    m = SLOTS * SPEC_TOKENS
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)

    gamma = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(bf16)
    rms = dict(prologue=Prologue(norm="rmsnorm"), gamma=gamma)
    # positions of 8 slots' 4-token blocks at ragged lengths
    pos = (torch.tensor([4, 64, 68, 130, 257, 300, 400, 508],
                        device=dev)[:, None]
           + torch.arange(SPEC_TOKENS, device=dev)).reshape(-1)
    sin, cos = rope_tables(pos, hd, cfg.rope_theta)
    x = rnd(m, d)
    return [
        ("verify_qk_rope", x, rnd(d, nqk, std=d ** -0.5),
         dict(epilogue=Epilogue(rope=True, head_dim=hd), sin=sin, cos=cos,
              **rms), False),
        ("verify_v", x, rnd(d, nv, std=d ** -0.5), dict(**rms), False),
        ("verify_up", x, rnd(d, f, std=d ** -0.5),
         dict(epilogue=Epilogue(activation="silu", gate=True),
              b2=rnd(d, f, std=d ** -0.5), **rms), True),
        ("verify_down", rnd(m, f), rnd(f, d, std=f ** -0.5),
         dict(epilogue=Epilogue(residual=True, scale=True),
              residual=rnd(m, d), scale=1.0), True),
    ]


def measure_verify_gemms(cfg, dev, gen, timer):
    """gemm_fused at the verify step's M = 32 (verify_gemm_cases) against
    its plain version, timed with the bare product's torch.matmul and the
    bound; rows 0-7 of the M = 32 call must equal the M = 8 call on those
    rows bit for bit (the planner gives every M of one tile row one plan,
    so each row's sum keeps its order), as a verify row must equal the
    serial decode step's."""
    rows = []
    for name, a, b, kw, on_path in verify_gemm_cases(cfg, dev, gen):
        ep, pro, extra = fwd_args(kw)
        m, k = a.shape
        n = b.shape[1]

        def kernel(a=a, extra=extra):
            return gemm_ops._launch(a, b, ep, eps=pro.eps, **extra)[0]

        def plain():
            return gemm_ops.forward_ref(a, b, ep, pro, **extra)[0]

        got, want = kernel(), plain()
        few = {key: (v[:SLOTS] if key in ("sin", "cos", "residual")
                     and v is not None else v) for key, v in extra.items()}
        serial = kernel(a[:SLOTS].contiguous(), few)
        torch.cuda.synchronize()
        err, tol = check_close(f"gemm_fused[{name}]", got, want, 2 ** -6,
                               2e-2)
        diff = (got[:SLOTS].float() - serial.float()).abs().max().item()
        log(f"[kernel] gemm_fused[{name}]: rows 0-{SLOTS - 1} of M {m} "
            f"{'equal' if diff == 0 else 'DIFFER FROM'} the M {SLOTS} call "
            f"bit for bit (max |diff| {diff:.4g})")
        if diff != 0:
            raise AssertionError(f"gemm_fused[{name}]: the M {m} call's first "
                                 f"rows differ from the M {SLOTS} call")
        gated = ep.gate
        b_lib = torch.cat([b, kw["b2"]], dim=1) if gated else b
        flops = 2 * m * n * k * (2 if gated else 1)
        traffic = nbytes(a, b, kw.get("b2"), kw.get("gamma"),
                         kw.get("residual"), kw.get("sin"), kw.get("cos"),
                         got)
        b_ms, b_by = bound(traffic, (flops, PEAK_BF16))
        rows.append(dict(
            case=name, shape=[m, k, n], max_abs_err=err, tolerance=tol,
            on_verify_path=on_path, rows_bitwise_vs_m8=True,
            ms=timer.ms(kernel), plain_ms=timer.ms(plain),
            library_ms=timer.ms(lambda: torch.matmul(a, b_lib)),
            bound_ms=b_ms, bound_by=b_by))
        del got, want, serial, b_lib
    return rows


def fwd_args(kw):
    """(epilogue, prologue, the other keyword arguments of ops._launch and
    ops.forward_ref) of a case's gemm_fused keyword arguments."""
    return (kw.get("epilogue", EPILOGUE_NONE),
            kw.get("prologue", PROLOGUE_NONE),
            dict(b2=kw.get("b2"), bias=None, residual=kw.get("residual"),
                 scale=kw.get("scale"), sin=kw.get("sin"), cos=kw.get("cos"),
                 gamma=kw.get("gamma"), beta=kw.get("beta"),
                 out_dtype=torch.bfloat16))


def entry_arity(path: str, entry: str) -> int:
    """The number of parameters of a C entry point in a source."""
    import re
    with open(path) as fh:
        match = re.search(rf"\bint\s+{entry}\s*\(([^)]*)\)", fh.read())
    return len(match.group(1).split(",")) if match else 0


def baseline_kernels(csrc: str) -> dict:
    """An earlier tree's kernels, built like the port's from the sources in
    ``csrc`` (their own headers included): GEMM backward dA and dB (whose
    entry points are this tree's), and, where the tree has them, the WMMA
    forward ``gemm_fused.cu`` (its own entry point: no row-pass scratch,
    workspace or plan; None when the entry is this tree's, PR 16's on) and
    the two-pass WMMA ``flash_bwd.cu`` (its own entry point: pass 0 dq,
    pass 1 dk and dv; None when the entry is this tree's), the flash
    forward ``flash_fwd.cu`` (PR 17 and before: the WMMA kernel), whose
    entry point has this tree's arity and arguments, the decode
    kernels ``flash_decode.cu`` and ``flash_decode_paged.cu`` whose entry
    points write fp32 partials (None otherwise), or whose entry points
    are this tree's (``flash_decode_same``, ``flash_decode_paged_same``:
    the kernels that merge their splits in the launch), and ``rope.cu`` and
    ``fused_norm.cu``, whose entry points are this tree's; the TMA +
    wgmma forward of PRs 16-21 (``fwd_sm90``: rmsnorm and the gated silu
    only, no beta or mean, the gate bit without an activation code); and
    a forward whose entry point is this tree's (``fwd_same``; one that
    saves no non-gated preact). A dA whose entry point takes no mean and
    no dbeta partials is built with that entry point and runs the rmsnorm
    and plain chains only (:func:`baseline_da`)."""
    from repro_torch.kernels._build import CudaKernel, build_all

    P, I, Fl, L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    root = os.path.abspath(csrc)
    wmma_fwd = [P] * 12 + [Fl, Fl] + [I] * 5 + [P]
    sm90_fwd = [P] * 14 + [Fl, Fl] + [I] * 7 + [P]
    # a dA without the layernorm pass: no mean, no dbeta partials
    rms_da = [P] * 9 + [I] * 5 + [P]
    da_path = os.path.join(root, "gemm_bwd_da.cu")
    da_args = (rms_da if entry_arity(da_path, "gemm_bwd_da_launch")
               == len(rms_da) else gemm_bwd.DA_KERNEL.argtypes)
    two_pass = [P] * 9 + [I] * 7 + [L] * 12 + [Fl, Fl, I, I, P]
    partials = [P] * 7 + [I] * 6 + [Fl, Fl, I, P]
    paged_partials = [P] * 8 + [I] * 7 + [Fl, Fl, I, P]
    kerns = {}
    for key, src, entry, args in (
            ("da", "gemm_bwd_da.cu", "gemm_bwd_da_launch", da_args),
            ("db", "gemm_bwd_db.cu", "gemm_bwd_db_launch",
             gemm_bwd.DB_KERNEL.argtypes),
            ("fwd", "gemm_fused.cu", "gemm_fused_launch", wmma_fwd),
            ("fwd_sm90", "gemm_fused.cu", "gemm_fused_launch", sm90_fwd),
            ("fwd_same", "gemm_fused.cu", "gemm_fused_launch",
             gemm_ops.KERNEL.argtypes),
            ("flash_bwd", "flash_bwd.cu", "flash_bwd_launch", two_pass),
            ("flash_fwd", "flash_fwd.cu", "flash_fwd_launch",
             attn_ops.KERNEL.argtypes),
            ("flash_decode", "flash_decode.cu", "flash_decode_launch",
             partials),
            ("flash_decode_paged", "flash_decode_paged.cu",
             "flash_decode_paged_launch", paged_partials),
            ("flash_decode_same", "flash_decode.cu", "flash_decode_launch",
             attn_decode.KERNEL.argtypes),
            ("flash_decode_paged_same", "flash_decode_paged.cu",
             "flash_decode_paged_launch", attn_decode.PAGED_KERNEL.argtypes),
            ("rope", "rope.cu", "rope_launch", kernels.ROPE_KERNEL.argtypes),
            ("fused_norm", "fused_norm.cu", "fused_norm_launch",
             kernels.FUSED_NORM_KERNEL.argtypes)):
        path = os.path.join(root, src)
        if entry_arity(path, entry) == len(args):
            kerns[key] = CudaKernel(f"baseline_{src[:-3]}", path, entry, args)
    log(f"[build] baseline from {root}: {sorted(kerns)}")
    build_all(list(kerns.values()))
    return {"fwd": None, "fwd_sm90": None, "fwd_same": None,
            "da": None, "db": None, "flash_bwd": None,
            "flash_fwd": None,
            "flash_decode": None, "flash_decode_paged": None,
            "flash_decode_same": None, "flash_decode_paged_same": None,
            "rope": None, "fused_norm": None, **kerns}


def baseline_fwd(kern, a, b, kw, save):
    """A launch of the earlier forward on one case's operands; its launches
    are not counted."""
    ep, pro, extra = fwd_args(kw)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    rstd = (torch.empty((m,), dtype=torch.float32, device=a.device)
            if extra["gamma"] is not None else None)
    pre = ([torch.empty_like(out) for _ in range(2)] if save
           else [None, None])

    def ptr(t):
        return None if t is None else t.data_ptr()

    scale = float(extra["scale"]) if extra["scale"] is not None else 1.0

    def launch():
        kern.check(kern.fn()(
            ptr(a), ptr(b), ptr(extra["b2"]), ptr(out), ptr(extra["gamma"]),
            ptr(rstd), None, ptr(extra["residual"]), ptr(extra["sin"]),
            ptr(extra["cos"]), ptr(pre[0]), ptr(pre[1]), scale,
            float(pro.eps or 0.0), m, n, k, gemm_ops.chain_flags(ep),
            ep.head_dim, torch.cuda.current_stream().cuda_stream))
        return out
    return launch


def baseline_fwd_sm90(kern, a, b, kw, save):
    """A launch of the TMA + wgmma forward of PRs 16-21 (its entry point:
    no beta, no mean, the gate bit meaning the gated silu) on one case's
    operands, at this tree's plan; its launches are not counted."""
    ep, pro, extra = fwd_args(kw)
    m, k = a.shape
    n = b.shape[1]
    dev = a.device
    hd = ep.head_dim if ep.rope else 0
    tile_n, splits = gemm_ops.plan_gemm(m, n, k, gemm_ops.sm_count(dev),
                                        gate=ep.gate, head_dim=hd,
                                        act=ep.activation != "none")
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    norm = extra["gamma"] is not None
    rstd = torch.empty((m,), dtype=torch.float32, device=dev) if norm else None
    an = torch.empty((m, k), dtype=a.dtype, device=dev) if norm else None
    ws = (torch.empty((splits, m, gemm_ops.raw_width(n, tile_n, ep.gate)),
                      dtype=torch.float32, device=dev)
          if gemm_ops.staged(ep, splits) else None)
    pre = ([torch.empty_like(out) for _ in range(2)] if save
           else [None, None])

    def ptr(t):
        return None if t is None else t.data_ptr()

    scale = float(extra["scale"]) if extra["scale"] is not None else 1.0
    flags = gemm_ops.chain_flags(ep) & 31      # without the activation code

    def launch():
        kern.check(kern.fn()(
            ptr(a), ptr(b), ptr(extra["b2"]), ptr(out), ptr(extra["gamma"]),
            ptr(rstd), ptr(an), None, ptr(extra["residual"]),
            ptr(extra["sin"]), ptr(extra["cos"]), ptr(pre[0]), ptr(pre[1]),
            ptr(ws), scale, float(pro.eps or 0.0), m, n, k, flags, hd,
            tile_n, splits, torch.cuda.current_stream().cuda_stream))
        return out
    return launch


def measure_gemm(cfg, dev, gen, timer, old=None, cases=None,
                 sweep_plans: bool = True):
    """Each gemm_fused launch of the main paths (llama-1b's, then
    whisper-base's and bert-110m's, ENCODER_GEMMS, then mixtral-8x7b's,
    ``moe_gemm_cases``, then recurrentgemma-2b's, ``rg_gemm_cases``, then
    internvl2-2b's, ``ivl_gemm_cases``, then llama4-maverick's,
    ``mav_gemm_cases``, then phase 21's expert buckets,
    ``dist_gemm_cases``) against its plain
    version (the output, the gated chain's saved preacts and the row
    statistics), timed as planned and at every (tile width, split count)
    the sweep reaches: each width the chain takes, unsplit and split as
    the planner would split it at that width; with a norm prologue also
    without it (the row pass's share), and with the layernorm prologue the
    same product with the rmsnorm prologue (what layernorm's second pass
    over the row costs). Library yardstick: the bare product(s) in one
    torch.matmul call (no single PyTorch call computes the fused chain).
    Bound: the operands read and the outputs (with the row statistics and
    the preacts) written once, or 2 M N K operations per product at the
    bf16 peak. With ``old`` (baseline_kernels), the earlier forward in
    turns, on the chains it takes. ``cases``: others than these (phase
    22b's), a case whose kwargs hold ``f32_product`` the chainless
    product's fp32 accumulators at one split (the staged route also
    writes its bf16 store: in the bound); ``sweep_plans`` False times the
    planned launch only."""
    rows = []
    sms = gemm_ops.sm_count(dev)
    if cases is None:
        cases = (gemm_cases(cfg, dev, gen) + encoder_gemm_cases(dev, gen)
                 + moe_gemm_cases(dev, gen) + rg_gemm_cases(dev, gen)
                 + ivl_gemm_cases(dev, gen) + mav_gemm_cases(dev, gen)
                 + dist_gemm_cases(dev, gen))
    for name, a, b, kw, save in cases:
        ep, pro, extra = fwd_args(kw)
        f32 = kw.get("f32_product", False)
        if f32:
            extra["out_dtype"] = torch.float32
        m, k = a.shape
        n = b.shape[1]
        gated = ep.gate
        hd = ep.head_dim if ep.rope else 0
        ln = pro.norm == "layernorm"

        def kernel(plan=None):
            if f32:
                plan = plan or (gemm_ops.plan_gemm(m, n, k, sms)[0], 1)
                return gemm_ops._launch(a, b, ep, eps=None, plan=plan,
                                        f32_product=True,
                                        **dict(extra,
                                               out_dtype=torch.bfloat16))
            return gemm_ops._launch(a, b, ep, eps=pro.eps, layernorm=ln,
                                    save_preact=save, plan=plan, **extra)

        def plain():
            return gemm_ops.forward_ref(a, b, ep, pro, save_preact=save,
                                        **extra)

        got, rstd, preacts = kernel()
        want, _, want_pre = plain()
        torch.cuda.synchronize()
        err, tol = check_close(f"gemm_fused[{name}]", got, want, 2 ** -6,
                               2e-2)
        for i, (p_, w_) in enumerate(zip(preacts, want_pre)):
            err = max(err, check_close(f"gemm_fused[{name}].preact{i + 1}",
                                       p_, w_, 2 ** -6, 2e-2)[0])
        if ln:
            _, mean_w, rstd_w = ln_rows_ref(a, kw["gamma"], kw.get("beta"),
                                            pro.eps)
            check_close(f"gemm_fused[{name}].mean", rstd[0], mean_w, 1e-5,
                        1e-5)
            check_close(f"gemm_fused[{name}].rstd", rstd[1], rstd_w, 1e-5,
                        0.0)
        elif rstd is not None:
            check_close(f"gemm_fused[{name}].rstd", rstd,
                        rms_rows_ref(a, kw["gamma"], pro.eps)[1], 1e-5, 0.0)
        del want, want_pre
        b_lib = torch.cat([b, kw["b2"]], dim=1) if gated else b
        flops = 2 * m * n * k * (2 if gated else 1)
        traffic = nbytes(a, b, kw.get("b2"), kw.get("gamma"), kw.get("beta"),
                         kw.get("residual"), kw.get("sin"), kw.get("cos"),
                         got, rstd, *preacts) + (2 * m * n if f32 else 0)
        b_ms, b_by = bound(traffic, (flops, PEAK_BF16))
        plan = gemm_ops.plan_gemm(m, n, k, sms, gate=gated, head_dim=hd,
                                  act=ep.activation != "none")
        if f32:
            plan = (plan[0], 1)
        sweep = {}
        for w in (gemm_ops.tile_widths(gated, hd) if sweep_plans else ()):
            split = gemm_ops.split_count(
                gemm_ops.tile_count(m, n, w, gated), k, sms)
            for sp in sorted({1, 1 if f32 else split}):
                sweep[f"{w}x{sp}"] = timer.ms(lambda: kernel((w, sp)))
        row = dict(
            case=name, shape=[m, k, n], max_abs_err=err, tolerance=tol,
            saves_preacts=save, ms=timer.ms(kernel), plain_ms=timer.ms(plain),
            library_ms=timer.ms(lambda: torch.matmul(a, b_lib)),
            bound_ms=b_ms, bound_by=b_by, plan=f"{plan[0]}x{plan[1]}",
            ms_by_plan=sweep)
        if extra["gamma"] is not None:
            # the row pass's share: the same product without the prologue
            no_norm = dict(extra, gamma=None, beta=None)
            row["no_prologue_ms"] = timer.ms(lambda: gemm_ops._launch(
                a, b, ep, eps=None, save_preact=save, **no_norm))
        if ln:
            # layernorm's second pass: the same chain on the rmsnorm prologue
            rms = dict(extra, beta=None)
            row["rmsnorm_ms"] = timer.ms(lambda: gemm_ops._launch(
                a, b, ep, eps=1e-6, save_preact=save, **rms))
        us = {p_: round(t * 1e3, 1) for p_, t in sweep.items()}
        log(f"[kernel] gemm_fused[{name}] by tile width x splits, us: {us}; "
            f"picked {row['plan']}, fastest "
            f"{min(sweep, key=sweep.get) if sweep else 'not swept'}"
            + (f"; without the prologue {row['no_prologue_ms'] * 1e3:.1f} "
               f"us against {row['ms'] * 1e3:.1f}"
               if "no_prologue_ms" in row else "")
            + (f"; on the rmsnorm prologue {row['rmsnorm_ms'] * 1e3:.1f} us"
               if ln else ""))
        if save and not gated:
            # the preact store's own cost: the same launch without it
            row["no_save_ms"] = timer.ms(lambda: gemm_ops._launch(
                a, b, ep, eps=pro.eps, layernorm=ln, **extra))
        # the earlier kernels with their own entry points take rmsnorm and
        # the gated silu only; one with this tree's entry point takes every
        # chain (it may save no non-gated preact)
        earlier = old and (old["fwd"] or old["fwd_sm90"] or old["fwd_same"])
        if earlier is not None and (old["fwd_same"] is not None or (
                not ln and (ep.activation == "none" or ep.gate
                            and ep.activation == "silu"))):
            if old["fwd_same"] is not None:
                def old_fn():
                    return gemm_ops._launch(
                        a, b, ep, eps=pro.eps, layernorm=ln,
                        save_preact=save and gated,
                        kernel=old["fwd_same"], **extra)[0]
            else:
                old_fn = (baseline_fwd(earlier, a, b, kw, save)
                          if old["fwd"] is not None
                          else baseline_fwd_sm90(earlier, a, b, kw, save))
            # the baseline computes the same function
            check_close(f"baseline gemm_fused[{name}]", old_fn(), got,
                        2 ** -6, 2e-2)
            turns = [timer.ms(old_fn), timer.ms(kernel), timer.ms(kernel),
                     timer.ms(old_fn)]
            row.update(baseline_turns_ms=turns,   # baseline, new, new, baseline
                       baseline_ms=(turns[0] + turns[3]) / 2,
                       new_in_turns_ms=(turns[1] + turns[2]) / 2)
            log(f"[kernel] gemm_fused[{name}] baseline "
                f"{row['baseline_ms'] * 1e3:.1f} us against "
                f"{row['new_in_turns_ms'] * 1e3:.1f} in turns"
                + (f" (the baseline saves no preact; this kernel without "
                   f"the save {row['no_save_ms'] * 1e3:.1f} us)"
                   if "no_save_ms" in row else ""))
        rows.append(row)
        del got, rstd, preacts, b_lib
    return rows


def baseline_flash_fwd(kern, q, k, v):
    """The earlier flash forward (the entry point's arguments are this
    tree's) as one callable on a causal case's q, k, v; its launches are
    not counted."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)

    def launch():
        kern.check(kern.fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, hkv, sq, skv, d, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], float(d ** -0.5), 0.0, 1, 0,
            torch.cuda.current_stream().cuda_stream))
        return out, lse
    return launch


def measure_flash(cfg, dev, gen, timer, old=None):
    """The flash forward at its three main-path shapes, causal, q/k/v as the
    model passes them (strided views of the q|k projection output and the
    v projection output): served prefill (B 4, S 256), the paged engine's
    lone-sequence prefill (B 1, S 256) and training (B 4, S 1024)
    (``flash_row``). With ``old`` (baseline_kernels), the earlier kernel,
    held to the plain version, in turns with this one (baseline, new, new,
    baseline)."""
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bf16 = torch.bfloat16
    rows = []
    for case, bsz, seq in (("prefill_causal_gqa", BATCH, PROMPT),
                           ("paged_prefill_causal_gqa", 1, PROMPT),
                           ("train_causal_gqa", TRAIN_BATCH, TRAIN_SEQ)):
        qk = torch.randn(bsz, seq, (h + hkv) * hd, generator=gen,
                         device=dev).to(bf16)
        v = torch.randn(bsz, seq, hkv * hd, generator=gen,
                        device=dev).to(bf16)
        q = qk[..., : h * hd].reshape(bsz, seq, h, hd).transpose(1, 2)
        k = qk[..., h * hd:].reshape(bsz, seq, hkv, hd).transpose(1, 2)
        v = v.reshape(bsz, seq, hkv, hd).transpose(1, 2)
        row = flash_row(case, q, k, v, True, timer)
        if old is not None and old["flash_fwd"] is not None:
            old_fn = baseline_flash_fwd(old["flash_fwd"], q, k, v)
            got_old = old_fn()
            torch.cuda.synchronize()
            # the baseline computes the same function
            check_close(f"baseline flash_attention_fwd[{case}]", got_old[0],
                        flash_attention_fwd_ref(q, k, v, causal=True)[0],
                        2e-2, 2e-2)
            turns = [timer.ms(old_fn), timer.ms(row["kernel"]),
                     timer.ms(row["kernel"]), timer.ms(old_fn)]
            row.update(baseline_turns_ms=turns,   # baseline, new, new, baseline
                       baseline_ms=(turns[0] + turns[3]) / 2,
                       new_in_turns_ms=(turns[1] + turns[2]) / 2)
            log(f"[kernel] flash_attention_fwd[{case}] baseline "
                f"{row['baseline_ms'] * 1e3:.1f} us against "
                f"{row['new_in_turns_ms'] * 1e3:.1f} in turns")
        del row["kernel"]
        rows.append(row)
    return rows


def flash_row(case, q, k, v, causal, timer, window=None):
    """One flash forward case against its plain version (out and lse),
    with its bound (``ops.forward_work``: the two products per visible
    pair at the bf16 peak, or q, k, v, out and lse moved once) and
    F.scaled_dot_product_attention on contiguous copies (with a
    ``window``, under the causal window as an explicit mask); the row
    keeps the kernel's callable under "kernel" for turns with a
    baseline."""
    b, h, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]

    def kernel():
        return flash_attention_fwd(q, k, v, causal=causal, window=window)

    def plain():
        return flash_attention_fwd_ref(q, k, v, causal=causal, window=window)

    out, lse = kernel()
    want, want_lse = plain()
    torch.cuda.synchronize()
    err, tol = check_close(f"flash_attention_fwd[{case}]", out, want, 2e-2,
                           2e-2)
    lse_err, _ = check_close(f"flash_attention_fwd[{case}][lse]", lse,
                             want_lse, 1e-4, 1e-4)
    work = attn_ops.forward_work(b, h, hkv, sq, skv, hd, causal=causal,
                                 window=window)
    b_ms, b_by = bound(work["bytes"], (work["flops"], PEAK_BF16))
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    lib = (dict(is_causal=causal) if window is None else
           dict(attn_mask=window_mask(sq, skv, causal, window, q.device)))
    row = dict(
        case=case, shape=[b, h, hkv, sq, skv, hd],
        max_abs_err=max(err, lse_err), tolerance=tol, ms=timer.ms(kernel),
        plain_ms=timer.ms(plain),
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, enable_gqa=True, **lib)),
        bound_ms=b_ms, bound_by=b_by, kernel=kernel)
    if window is not None:
        row["window"] = window
    log(f"[kernel] flash_attention_fwd[{case}] {row['ms'] * 1e3:.1f} us "
        f"(bound {b_ms * 1e3:.2f}, {b_by}; "
        f"{work['flops'] / row['ms'] * 1e3 / PEAK_BF16:.1%} of the bf16 "
        f"peak); SDPA {row['library_ms'] * 1e3:.1f} us")
    return row


def measure_flash_window(dev, gen, timer):
    """The flash forward at phase 12c's prefill: mixtral-8x7b's heads (32
    over 8, head_dim 128), B WIN_BATCH, S WIN_PROMPT, causal within the
    4096-token window, q, k and v strided views of the projections."""
    cfg = get_config(MOE_ARCH)
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bf16 = torch.bfloat16
    bsz, seq = WIN_BATCH, WIN_PROMPT
    qk = torch.randn(bsz, seq, (h + hkv) * hd, generator=gen,
                     device=dev).to(bf16)
    v = torch.randn(bsz, seq, hkv * hd, generator=gen, device=dev).to(bf16)
    q = qk[..., : h * hd].reshape(bsz, seq, h, hd).transpose(1, 2)
    k = qk[..., h * hd:].reshape(bsz, seq, hkv, hd).transpose(1, 2)
    v = v.reshape(bsz, seq, hkv, hd).transpose(1, 2)
    row = flash_row("mixtral_prefill_window", q, k, v, True, timer,
                    window=cfg.attn_window)
    del row["kernel"]
    return [row]


def measure_flash_encoder(dev, gen, timer):
    """The flash forward at whisper-base's and bert-110m's shapes (phase
    9), q, k and v as the models pass them: the encoder's non-causal self
    attention over 1500 frames (a ragged last tile; strided views of the
    q|k and v projections), the decoder's causal prefill of 64 tokens, its
    cross attention of 64 queries over the 1500 frames written to the
    cache (contiguous), and bert's non-causal 8 x 512."""
    bf16 = torch.bfloat16
    rows = []
    for case, bsz, heads, sq, skv, causal, cache in (
            ("whisper_enc_self", W_BATCH, 8, 1500, 1500, False, False),
            ("whisper_dec_self", W_BATCH, 8, W_PROMPT, W_PROMPT, True, False),
            ("whisper_cross", W_BATCH, 8, W_PROMPT, 1500, False, True),
            ("bert_self", B_BATCH, 12, B_SEQ, B_SEQ, False, False)):
        hd = 64
        qk = torch.randn(bsz, sq, 2 * heads * hd, generator=gen,
                         device=dev).to(bf16)
        q = qk[..., :heads * hd].reshape(bsz, sq, heads, hd).transpose(1, 2)
        if cache:
            k, v = (torch.randn(bsz, heads, skv, hd, generator=gen,
                                device=dev).to(bf16) for _ in range(2))
        else:
            k = qk[..., heads * hd:].reshape(bsz, sq, heads, hd).transpose(
                1, 2)
            v = torch.randn(bsz, sq, heads * hd, generator=gen,
                            device=dev).to(bf16).reshape(
                bsz, sq, heads, hd).transpose(1, 2)
        row = flash_row(case, q, k, v, causal, timer)
        del row["kernel"]
        rows.append(row)
    return rows


def decode_row(case, q, kc, vc, length, timer, window=None):
    """One flash_decode case (every row at ``length``; past the cache's
    slots it has wrapped the ring) against its plain version, with its
    bound (what the step needs: q, the cache rows it sees (valid and
    inside the ``window``) and lengths read, the output written; q @ k^T
    and p @ v on bf16 operands) and SDPA over the masked cache; the row
    keeps the kernel's callable under "kernel" for turns with a
    baseline."""
    b, hkv, g, hd = q.shape
    slots = kc.shape[2]
    lengths = torch.full((b,), length, dtype=torch.int32, device=q.device)

    def kernel():
        return flash_decode(q, kc, vc, lengths, window=window)

    def plain():
        o, m, l = decode_partials_ref(q, kc, vc, lengths, window=window,
                                      scale=hd ** -0.5)
        return combine_splits(o, m, l).to(q.dtype)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err, tol = check_close(f"flash_decode[{case}]", got, want, 2e-2, 2e-2)
    actual, seen = ring_positions(lengths, slots)
    if window is not None:
        seen &= (lengths.long()[:, None] - 1 - actual) < window
    valid = int(seen[0].sum())
    traffic = (nbytes(q, lengths, got)
               + 2 * b * hkv * valid * hd * kc.element_size())
    flops = 2 * 2 * b * hkv * g * valid * hd
    b_ms, b_by = bound(traffic, (flops, PEAK_BF16))
    mask = seen[:, None, None, :]
    q4 = q.reshape(b, hkv * g, 1, hd)
    row = dict(
        case=case, shape=[b, hkv * g, hkv, slots, hd], max_abs_err=err,
        tolerance=tol, ms=timer.ms(kernel), plain_ms=timer.ms(plain),
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
            q4, kc, vc, attn_mask=mask, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by, kernel=kernel)
    if window is not None:
        row.update(window=window, length=length)
    return row


def measure_decode_window(dev, gen, timer):
    """flash_decode at phase 12's ring: mixtral-8x7b's heads (32 over 8,
    head_dim 128), B BATCH, over a 4096-slot ring (the window) that phase
    12c's last decode step has wrapped (length WIN_PROMPT + WIN_NEW - 1)."""
    cfg = get_config(MOE_ARCH)
    h, hkv, hd, w = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                     cfg.attn_window)
    bf16 = torch.bfloat16
    q = torch.randn(BATCH, hkv, h // hkv, hd, generator=gen,
                    device=dev).to(bf16)
    kc, vc = (torch.randn(BATCH, hkv, w, hd, generator=gen,
                          device=dev).to(bf16) for _ in range(2))
    row = decode_row("mixtral_ring_window", q, kc, vc,
                     WIN_PROMPT + WIN_NEW - 1, timer, window=w)
    del row["kernel"]
    return [row]


def measure_decode_encoder(dev, gen, timer):
    """flash_decode at whisper-base's decode step (phase 9): the decoder's
    self attention at its last step (W_MAX_LEN slots) and its cross
    attention over the 1500 static slots, every one valid (a ragged last
    key tile)."""
    bf16 = torch.bfloat16
    rows = []
    for case, slots, length in (
            ("whisper_self", W_MAX_LEN, W_PROMPT + W_NEW - 1),
            ("whisper_cross", 1500, 1500)):
        q = torch.randn(W_BATCH, 8, 1, 64, generator=gen, device=dev).to(bf16)
        kc, vc = (torch.randn(W_BATCH, 8, slots, 64, generator=gen,
                              device=dev).to(bf16) for _ in range(2))
        row = decode_row(case, q, kc, vc, length, timer)
        del row["kernel"]
        rows.append(row)
    return rows


def baseline_decode(kern, q, k, v, lengths):
    """PR 18's contiguous decode kernel (fp32 partials of 64-slot splits)
    and the plain combine after it, as one callable; its launches are not
    counted."""
    b, hkv, g, d = q.shape
    slots = k.shape[2]
    ns = -(-slots // BLOCK_KV)
    o = torch.empty((b, hkv, ns, g, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, ns, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)

    def launch():
        kern.check(kern.fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            o.data_ptr(), m.data_ptr(), l.data_ptr(), b, hkv, g, slots, d,
            BLOCK_KV, float(d ** -0.5), 0.0, 0,
            torch.cuda.current_stream().cuda_stream))
        return combine_splits(o, m, l).to(q.dtype)
    return launch


def baseline_decode_paged(kern, q, k_pages, v_pages, table, lengths, t):
    """PR 18's paged decode kernel (fp32 partials a page) and the plain
    combine after it, as one callable; its launches are not counted."""
    b, hkv, rows, d = q.shape
    page, mp = k_pages.shape[2], table.shape[1]
    o = torch.empty((b, hkv, mp, rows, d), dtype=torch.float32,
                    device=q.device)
    m = torch.empty((b, hkv, mp, rows), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)

    def launch():
        kern.check(kern.fn()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), lengths.data_ptr(), o.data_ptr(), m.data_ptr(),
            l.data_ptr(), b, hkv, rows, page, mp, d, t, float(d ** -0.5),
            0.0, 0, torch.cuda.current_stream().cuda_stream))
        return combine_splits(o, m, l).to(q.dtype)
    return launch


def decode_turns(row, name, old_fn, kernel, want, timer):
    """The earlier kernel (with the plain combine), held to the plain
    version, in turns with this one: baseline, new, new, baseline."""
    got_old = old_fn()
    torch.cuda.synchronize()
    check_close(f"baseline {name}", got_old, want, 2e-2, 2e-2)
    turns = [timer.ms(old_fn), timer.ms(kernel), timer.ms(kernel),
             timer.ms(old_fn)]
    row.update(baseline_turns_ms=turns,
               baseline_ms=(turns[0] + turns[3]) / 2,
               new_in_turns_ms=(turns[1] + turns[2]) / 2)
    log(f"[kernel] {name} {row['ms'] * 1e3:.1f} us (bound "
        f"{row['bound_ms'] * 1e3:.2f}, {row['bound_by']}); SDPA "
        f"{row['library_ms'] * 1e3:.1f} us; baseline "
        f"{row['baseline_ms'] * 1e3:.1f} us against "
        f"{row['new_in_turns_ms'] * 1e3:.1f} in turns")


def measure_decode(cfg, dev, gen, timer, old=None):
    """The last decode step of the main path: every sequence at position
    PROMPT + NEW_TOKENS - 2 of a MAX_LEN-slot cache (``decode_row``). With
    ``old`` (baseline_kernels), the earlier kernel and its plain combine in
    turns with this one."""
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bf16 = torch.bfloat16
    length = PROMPT + NEW_TOKENS - 1
    q = torch.randn(BATCH, hkv, h // hkv, hd, generator=gen,
                    device=dev).to(bf16)
    kc = torch.randn(BATCH, hkv, MAX_LEN, hd, generator=gen, device=dev).to(bf16)
    vc = torch.randn(BATCH, hkv, MAX_LEN, hd, generator=gen, device=dev).to(bf16)
    row = decode_row("decode_step", q, kc, vc, length, timer)
    kernel = row.pop("kernel")
    if old is not None and (old["flash_decode"] is not None
                            or old["flash_decode_same"] is not None):
        lengths = torch.full((BATCH,), length, dtype=torch.int32, device=dev)
        o, m, l = decode_partials_ref(q, kc, vc, lengths, scale=hd ** -0.5)
        if old["flash_decode_same"] is not None:
            def old_fn():
                return attn_decode._launch(
                    q, kc, vc, lengths, window=None, scale=hd ** -0.5,
                    softcap=None, sinks=None, kernel=old["flash_decode_same"])
        else:
            old_fn = baseline_decode(old["flash_decode"], q, kc, vc, lengths)
        decode_turns(row, "flash_decode[decode_step]", old_fn, kernel,
                     combine_splits(o, m, l).to(q.dtype), timer)
    return [row]


def paged_cases(cfg, dev, gen):
    """The paged kernel's three shapes on the main path, over one 65-page
    pool whose tables are a seeded permutation: (name, q, table, lengths,
    q_tokens). The verify step's k is SPEC_TOKENS."""
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hkv
    bf16 = torch.bfloat16
    perm = np.random.default_rng(1).permutation(
        np.arange(1, SLOTS * MAX_PAGES + 1)).reshape(SLOTS, MAX_PAGES)
    table = torch.from_numpy(perm.astype(np.int32)).to(dev)

    def q(b, rows):
        return torch.randn(b, hkv, rows, hd, generator=gen, device=dev).to(bf16)

    def lens(*xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    return [
        # ragged decode lengths: an empty row and page-boundary crossings
        ("decode", q(SLOTS, g), table,
         lens(0, 1, 64, 65, 130, 257, 400, 512), 1),
        ("chunk", q(1, g * CHUNK), table[:1], lens(192 + CHUNK), CHUNK),
        ("verify", q(SLOTS, g * SPEC_TOKENS), table,
         lens(4, 64, 68, 130, 257, 300, 400, 512), SPEC_TOKENS),
    ]


def verify_serial_bits(name, kernel_fn, q, lengths, t, g):
    """Row t' of a T-token call against a 1-token call of that row's
    queries at length ``lengths - T + 1 + t'`` (the same visible keys): a
    verify row must be the serial decode step's bits. Returns (holds, max
    |diff|)."""
    b, hkv, _, d = q.shape
    got = kernel_fn(q, lengths, t).view(b, hkv, g, t, d)
    diff = 0.0
    for i in range(t):
        one = kernel_fn(q.view(b, hkv, g, t, d)[:, :, :, i].contiguous(),
                        lengths - (t - 1) + i, 1)
        diff = max(diff, (got[:, :, :, i].float() - one.float())
                   .abs().max().item())
    torch.cuda.synchronize()
    verdict = "equal" if diff == 0 else "DIFFER FROM"
    log(f"[kernel] {name}: verify rows {verdict} the serial T = 1 calls bit "
        f"for bit (max |diff| {diff:.4g})")
    return diff == 0, diff


def paged_row(name, q, table, lengths, t, k_pages, v_pages, timer,
              window=None):
    """One flash_decode_paged call of T = ``t`` tokens a row against its
    plain version, with its bound (what the call needs: each slot's K/V
    rows inside its rows' windows once, q, the table, the lengths and the
    output; q @ k^T and p @ v for every visible (row, key) pair, on bf16
    operands) and SDPA over the pre-gathered contiguous cache under the
    same mask. (row, the kernel's callable, its output, the plain one)."""
    dev = q.device
    b, hkv, rows, hd = q.shape
    g = rows // t
    scale = hd ** -0.5

    def plain():
        o, m, l = decode_partials_paged_ref(q, k_pages, v_pages, table,
                                            lengths, window=window,
                                            scale=scale, q_tokens=t)
        return combine_splits(o, m, l).to(q.dtype)

    def kernel():
        return flash_decode_paged(q, k_pages, v_pages, table, lengths,
                                  q_tokens=t, window=window)

    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    err, tol = check_close(f"flash_decode_paged[{name}]", got, want,
                           2e-2, 2e-2)
    # keys each query row sees: positions [lo, hz)
    hz = (lengths.long()[:, None] - t + 1
          + torch.arange(t, device=dev)[None, :])
    lo = (hz - window).clamp(min=0) if window else torch.zeros_like(hz)
    pairs = int((hz.clamp(min=0) - lo).clamp(min=0).sum()) * g * hkv
    valid_rows = int((lengths.long() - lo[:, 0]).clamp(min=0).sum())
    traffic = (nbytes(q, table, lengths, got)
               + 2 * valid_rows * hkv * hd * k_pages.element_size())
    flops = 2 * 2 * pairs * hd
    b_ms, b_by = bound(traffic, (flops, PEAK_BF16))
    # yardstick: SDPA over the pre-gathered contiguous cache
    kg = kvc.gather_pages(k_pages, table)
    vg = kvc.gather_pages(v_pages, table)
    span = kg.shape[2]
    q4 = q.reshape(b, hkv, g, t, hd).reshape(b, hkv * g, t, hd)
    idx = torch.arange(span, device=dev)[None, None, :]
    mask = ((idx < hz[:, :, None]) & (idx >= lo[:, :, None]))[:, None]
    row = dict(
        case=name, shape=[b, hkv * g, hkv, t, table.shape[1] * PAGE, hd],
        page=PAGE, max_abs_err=err, tolerance=tol,
        ms=timer.ms(kernel), plain_ms=timer.ms(plain),
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by)
    if window is not None:
        row["window"] = window
    return row, kernel, got, want


def measure_paged_window(dev, gen, timer):
    """flash_decode_paged at phase 12c's shapes: mixtral-8x7b's heads (32
    over 8, head_dim 128) within its 4096-token window, over WIN_PAGES-page
    tables of 64-token pages (a seeded permutation of a pool of WIN_BATCH x
    WIN_PAGES + 1 pages): both sequences' decode step past the window, and
    a CHUNK-token chunk at position 4096 (the 33rd of a prompt)."""
    cfg = get_config(MOE_ARCH)
    hkv, hd, w = cfg.num_kv_heads, cfg.head_dim, cfg.attn_window
    g = cfg.num_heads // hkv
    bf16 = torch.bfloat16
    n_pages = WIN_BATCH * WIN_PAGES + 1
    k_pages, v_pages = (torch.randn(n_pages, hkv, PAGE, hd, generator=gen,
                                    device=dev).to(bf16) for _ in range(2))
    perm = np.random.default_rng(3).permutation(
        np.arange(1, n_pages)).reshape(WIN_BATCH, WIN_PAGES)
    table = torch.from_numpy(perm.astype(np.int32)).to(dev)

    def q(b, rows):
        return torch.randn(b, hkv, rows, hd, generator=gen, device=dev).to(bf16)

    rows = []
    for name, q_, tab, lengths, t in (
            ("mixtral_decode_window", q(WIN_BATCH, g), table,
             [WIN_PROMPT + 40, WIN_PROMPT + WIN_NEW - 1], 1),
            ("mixtral_chunk_window", q(1, g * CHUNK), table[:1],
             [w + CHUNK], CHUNK)):
        lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
        rows.append(paged_row(name, q_, tab, lengths, t, k_pages, v_pages,
                              timer, window=w)[0])
    return rows


def measure_rg_attention(dev, gen, timer) -> dict:
    """Phase 15a's attention rows at recurrentgemma-2b's shapes, head_dim
    256, 10 query heads over one kv head: the flash forward at B RG_BATCH,
    S RG_PROMPT causal in the 2048-token window and at S 1024 with no
    window (q, k, v strided views of the projections); ``flash_decode``
    over the 2048-slot ring that 15b's last decode step has wrapped
    (length RG_PROMPT + RG_NEW - 1); ``flash_decode_paged`` at SLOTS
    ragged lengths 197-2300 over RG_PAGES-page tables of 64-token pages in
    the window. Returns {kernel name: rows}."""
    cfg = get_config(RG_ARCH)
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    w = cfg.rglru.local_window
    bf16 = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    out = {"flash_attention_fwd": [], "flash_decode": [],
           "flash_decode_paged": []}
    for case, seq, window in (("rg_prefill_window", RG_PROMPT, w),
                              ("rg_prefill_s1024", 1024, None)):
        qk, v = rnd(RG_BATCH, seq, (h + hkv) * hd), rnd(RG_BATCH, seq, hkv * hd)
        q = qk[..., : h * hd].reshape(RG_BATCH, seq, h, hd).transpose(1, 2)
        k = qk[..., h * hd:].reshape(RG_BATCH, seq, hkv, hd).transpose(1, 2)
        v = v.reshape(RG_BATCH, seq, hkv, hd).transpose(1, 2)
        row = flash_row(case, q, k, v, True, timer, window=window)
        del row["kernel"]
        out["flash_attention_fwd"].append(row)
    q = rnd(RG_BATCH, hkv, h // hkv, hd)
    kc, vc = rnd(RG_BATCH, hkv, w, hd), rnd(RG_BATCH, hkv, w, hd)
    row = decode_row("rg_ring_window", q, kc, vc, RG_PROMPT + RG_NEW - 1,
                     timer, window=w)
    del row["kernel"]
    out["flash_decode"].append(row)
    n_pages = SLOTS * RG_PAGES + 1
    k_pages, v_pages = rnd(n_pages, hkv, PAGE, hd), rnd(n_pages, hkv, PAGE, hd)
    perm = np.random.default_rng(15).permutation(
        np.arange(1, n_pages)).reshape(SLOTS, RG_PAGES)
    table = torch.from_numpy(perm.astype(np.int32)).to(dev)
    lengths = torch.tensor([197, 2300, 640, 1000, 65, 1500, 2047, 333],
                           dtype=torch.int32, device=dev)
    out["flash_decode_paged"].append(paged_row(
        "rg_decode_window", rnd(SLOTS, hkv, h // hkv, hd), table, lengths, 1,
        k_pages, v_pages, timer, window=w)[0])
    for name, rows in out.items():
        for r in rows:
            log(f"[15a] {name}[{r['case']}] head_dim 256: kernel "
                f"{r['ms'] * 1e3:.1f} us, plain {r['plain_ms'] * 1e3:.1f} us, "
                f"library {r['library_ms'] * 1e3:.1f} us, bound "
                f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    return out


def ivl_gemm_cases(dev, gen):
    """internvl2-2b's training GEMMs (phase 19) as (name, a, b, kwargs,
    save_preact) at M = IVL_TRAIN_BATCH x IVL_TRAIN_SEQ (the 256 patches and
    the text): q|k + rope (N 3072, head_dim 128) and v (N 1024) on the
    rmsnorm prologue, the SwiGLU up (2 x N 8192, saving its preacts as the
    training forward does) on it and the down (K 8192) with the residual
    store. The weights at std K^-1/2."""
    cfg = get_config(IVL_ARCH)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)

    rms = dict(prologue=Prologue(norm="rmsnorm"),
               gamma=(1 + 0.1 * torch.randn(d, generator=gen,
                                            device=dev)).to(bf16))
    m = IVL_TRAIN_BATCH * IVL_TRAIN_SEQ
    sin, cos = rope_tables(torch.arange(IVL_TRAIN_SEQ, device=dev), hd,
                           cfg.rope_theta)
    x = rnd(m, d)
    return [
        ("ivl_train_qk_rope", x,
         rnd(d, (cfg.num_heads + cfg.num_kv_heads) * hd, std=d ** -0.5),
         dict(epilogue=Epilogue(rope=True, head_dim=hd),
              sin=sin.repeat(IVL_TRAIN_BATCH, 1),
              cos=cos.repeat(IVL_TRAIN_BATCH, 1), **rms), False),
        ("ivl_train_v", x, rnd(d, cfg.num_kv_heads * hd, std=d ** -0.5),
         dict(**rms), False),
        ("ivl_train_swiglu_up", x, rnd(d, f, std=d ** -0.5),
         dict(epilogue=Epilogue(activation="silu", gate=True),
              b2=rnd(d, f, std=d ** -0.5), **rms), True),
        ("ivl_train_down", rnd(m, f), rnd(f, d, std=f ** -0.5),
         dict(epilogue=Epilogue(residual=True, scale=True),
              residual=rnd(m, d), scale=1.0), False)]


def ivl_train_gemm_cases(dev, gen):
    """``ivl_gemm_cases`` as (name, a, b, kwargs) for the GEMM backward."""
    return [c[:4] for c in ivl_gemm_cases(dev, gen)]


def measure_ivl_attention(dev, gen, timer) -> dict:
    """Phase 19d's attention rows at internvl2-2b's shapes, head_dim 128,
    16 query heads over 8 kv heads: the flash forward at its training
    shape, B IVL_TRAIN_BATCH, S IVL_TRAIN_SEQ causal (q, k, v strided views
    of the projections), and ``flash_decode_paged`` at SLOTS ragged lengths
    over IVL_PAGES-page tables of 64-token pages (19b's decode step).
    Returns {kernel name: rows}."""
    cfg = get_config(IVL_ARCH)
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bsz, seq = IVL_TRAIN_BATCH, IVL_TRAIN_SEQ
    bf16 = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    qk, v = rnd(bsz, seq, (h + hkv) * hd), rnd(bsz, seq, hkv * hd)
    q = qk[..., : h * hd].reshape(bsz, seq, h, hd).transpose(1, 2)
    k = qk[..., h * hd:].reshape(bsz, seq, hkv, hd).transpose(1, 2)
    v = v.reshape(bsz, seq, hkv, hd).transpose(1, 2)
    row = flash_row("ivl_train", q, k, v, True, timer)
    del row["kernel"], q, k, v, qk
    out = {"flash_attention_fwd": [row]}
    n_pages = SLOTS * IVL_PAGES + 1
    k_pages, v_pages = rnd(n_pages, hkv, PAGE, hd), rnd(n_pages, hkv, PAGE, hd)
    perm = np.random.default_rng(19).permutation(
        np.arange(1, n_pages)).reshape(SLOTS, IVL_PAGES)
    table = torch.from_numpy(perm.astype(np.int32)).to(dev)
    lengths = torch.tensor([701, 1212, 1242, 730, 65, 999, 1500, 333],
                           dtype=torch.int32, device=dev)
    out["flash_decode_paged"] = [paged_row(
        "ivl_decode", rnd(SLOTS, hkv, h // hkv, hd), table, lengths, 1,
        k_pages, v_pages, timer)[0]]
    for name, rows in out.items():
        for r in rows:
            log(f"[19d] {name}[{r['case']}] head_dim 128: kernel "
                f"{r['ms'] * 1e3:.1f} us, plain {r['plain_ms'] * 1e3:.1f} us, "
                f"library {r['library_ms'] * 1e3:.1f} us, bound "
                f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    return out


def mav_gemm_cases(dev, gen):
    """llama4-maverick's gemm_fused launches (phase 20) as (name, a, b,
    kwargs, save_preact): the prefill's q|k + rope (K 5120, N 6144,
    head_dim 128) on the rmsnorm prologue at M = BATCH x PROMPT, and an
    expert's dual-output silu-gated up projection with no prologue (2 x N
    8192) and its down projection with no epilogue (K 8192, N 5120) at M
    = BATCH x PROMPT and at a decode step's M = BATCH. The weights at std
    K^-1/2."""
    cfg = get_config(MAV_ARCH)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)

    rms = dict(prologue=Prologue(norm="rmsnorm"),
               gamma=(1 + 0.1 * torch.randn(d, generator=gen,
                                            device=dev)).to(bf16))
    m = BATCH * PROMPT
    sin, cos = rope_tables(torch.arange(PROMPT, device=dev), hd,
                           cfg.rope_theta)
    w_gate, w_in, w_out = (rnd(d, f, std=d ** -0.5), rnd(d, f, std=d ** -0.5),
                           rnd(f, d, std=f ** -0.5))
    up = dict(epilogue=Epilogue(activation="silu", gate=True), b2=w_in)
    x = rnd(m, d)
    cases = [
        ("mav_prefill_qk_rope", x,
         rnd(d, (cfg.num_heads + cfg.num_kv_heads) * hd, std=d ** -0.5),
         dict(epilogue=Epilogue(rope=True, head_dim=hd),
              sin=sin.repeat(BATCH, 1), cos=cos.repeat(BATCH, 1), **rms)),
        ("mav_expert_up", x, w_gate, dict(up)),
        ("mav_expert_down", rnd(m, f), w_out, {}),
        ("mav_decode_expert_up", rnd(BATCH, d), w_gate, dict(up)),
        ("mav_decode_expert_down", rnd(BATCH, f), w_out, {}),
    ]
    return [(*c, False) for c in cases]


def dist_gemm_cases(dev, gen):
    """Phase 21's expert launches at their buckets' rows (``moe._capacity``
    of the tokens a rank routes): llama4-maverick's expert up and down
    under ``moe_ep`` at a BATCH x PROMPT prefill's bucket (top-1 of 128,
    capacity factor 1.25: 16 rows) and a decode step's (8 rows), and
    mixtral-8x7b's expert chain under ``moe_tp`` at one rank's whole F
    (top-2 of 8: 320 rows at the prefill, 8 at a decode step), as (name,
    a, b, kwargs, save_preact). The weights at std K^-1/2."""
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)

    cases = []
    for arch, tag in ((MAV_ARCH, "mav_ep"), (TP_ARCH, "mixtral_tp")):
        cfg = get_config(arch)
        d, f = cfg.d_model, cfg.d_ff
        w_gate, w_in, w_out = (rnd(d, f, std=d ** -0.5),
                               rnd(d, f, std=d ** -0.5),
                               rnd(f, d, std=f ** -0.5))
        up = dict(epilogue=Epilogue(activation="silu", gate=True), b2=w_in)
        for when, tokens in (("prefill", BATCH * PROMPT), ("decode", BATCH)):
            rows = moe_mod._capacity(tokens, cfg)
            cases += [(f"{tag}_{when}_bucket_up", rnd(rows, d), w_gate,
                       dict(up)),
                      (f"{tag}_{when}_bucket_down", rnd(rows, f), w_out, {})]
    return [(*c, False) for c in cases]


def measure_mav_attention(dev, gen, timer) -> dict:
    """Phase 20's attention rows at llama4-maverick's heads, 40 over 8 kv
    heads (a GQA group of 5), head_dim 128: the flash forward at B BATCH,
    S PROMPT causal (q, k, v strided views of the projections);
    ``flash_decode`` at B BATCH over a MAX_LEN-slot cache at phase 4's
    last step (5 q rows a unit, the few-row body);
    ``flash_decode_paged`` over 8-page tables of 64-token pages at SLOTS
    ragged lengths (5 rows), a CHUNK-token chunk (640 rows) and verify
    steps of SPEC_TOKENS and SPEC_TOKENS + 1 tokens (20 and 25 rows, in
    16-row units of the few-row body as the 5-row serial step: the body
    goes by the group), each verify row held bit for bit to the serial
    T = 1 call at its position (required at one split). Returns {kernel
    name: rows}."""
    cfg = get_config(MAV_ARCH)
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hkv

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    qk, v = rnd(BATCH, PROMPT, (h + hkv) * hd), rnd(BATCH, PROMPT, hkv * hd)
    q = qk[..., : h * hd].reshape(BATCH, PROMPT, h, hd).transpose(1, 2)
    k = qk[..., h * hd:].reshape(BATCH, PROMPT, hkv, hd).transpose(1, 2)
    v = v.reshape(BATCH, PROMPT, hkv, hd).transpose(1, 2)
    row = flash_row("mav_prefill_g5", q, k, v, True, timer)
    del row["kernel"], q, k, v, qk
    out = {"flash_attention_fwd": [row]}
    kc, vc = rnd(BATCH, hkv, MAX_LEN, hd), rnd(BATCH, hkv, MAX_LEN, hd)
    row = decode_row("mav_decode_g5", rnd(BATCH, hkv, g, hd), kc, vc,
                     PROMPT + NEW_TOKENS - 1, timer)
    del row["kernel"]
    out["flash_decode"] = [row]
    n_pages = SLOTS * MAX_PAGES + 1
    k_pages, v_pages = rnd(n_pages, hkv, PAGE, hd), rnd(n_pages, hkv, PAGE, hd)
    perm = np.random.default_rng(20).permutation(
        np.arange(1, n_pages)).reshape(SLOTS, MAX_PAGES)
    table = torch.from_numpy(perm.astype(np.int32)).to(dev)

    def lens(*xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    verify = lens(4, 64, 68, 130, 257, 300, 400, 512)
    out["flash_decode_paged"] = []
    for name, q, tab, lengths, t in (
            ("mav_decode_g5", rnd(SLOTS, hkv, g, hd), table,
             lens(0, 1, 64, 65, 130, 257, 400, 512), 1),
            ("mav_chunk_g5", rnd(1, hkv, g * CHUNK, hd), table[:1],
             lens(192 + CHUNK), CHUNK),
            ("mav_verify_g5", rnd(SLOTS, hkv, g * SPEC_TOKENS, hd), table,
             verify, SPEC_TOKENS),
            ("mav_verify_g5_k1", rnd(SLOTS, hkv, g * (SPEC_TOKENS + 1), hd),
             table, verify + 1, SPEC_TOKENS + 1)):
        row = paged_row(name, q, tab, lengths, t, k_pages, v_pages, timer)[0]
        if t in (SPEC_TOKENS, SPEC_TOKENS + 1):
            units = attn_decode.decode_units(SLOTS, hkv, g * t, t)
            splits = attn_decode.plan_decode(
                units, MAX_PAGES * PAGE // attn_decode.KEY_TILE,
                gemm_ops.sm_count(dev))[0]
            holds, diff = verify_serial_bits(
                f"flash_decode_paged[{name}] ({splits} split(s))",
                lambda q_, l_, t_: flash_decode_paged(
                    q_, k_pages, v_pages, table, l_, q_tokens=t_),
                q, lengths, t, g)
            row.update(verify_rows_bitwise=holds, verify_rows_max_diff=diff,
                       splits=splits)
            if splits == 1 and not holds:
                raise AssertionError(
                    f"flash_decode_paged[{name}]: at one split a verify row "
                    f"differs from the serial call by {diff:.4g}")
        out["flash_decode_paged"].append(row)
    for name, rows in out.items():
        for r in rows:
            log(f"[20] {name}[{r['case']}] G 5, head_dim 128: kernel "
                f"{r['ms'] * 1e3:.1f} us, plain {r['plain_ms'] * 1e3:.1f} us, "
                f"library {r['library_ms'] * 1e3:.1f} us, bound "
                f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    return out


def measure_paged(cfg, dev, gen, timer, old=None):
    """The paged kernel at its three main-path shapes (paged_cases), and the
    verify step also over a 16-page bucket (900-1024 keys, two splits a
    unit, merged in the launch); each verify row held bit for bit to the
    serial T = 1 call at its position (it must hold at the main path's one
    split; over splits it is recorded); with ``old`` (baseline_kernels),
    the earlier kernel and its plain combine in turns with this one."""
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hkv
    bf16 = torch.bfloat16
    n_pages = SLOTS * MAX_PAGES + 1
    k_pages = torch.randn(n_pages, hkv, PAGE, hd, generator=gen,
                          device=dev).to(bf16)
    v_pages = torch.randn(n_pages, hkv, PAGE, hd, generator=gen,
                          device=dev).to(bf16)
    scale = hd ** -0.5
    rows = []
    # the multi-split verify: 8 slots of a 16-page bucket of a 129-page pool
    big_k = torch.randn(2 * n_pages - 1, hkv, PAGE, hd, generator=gen,
                        device=dev).to(bf16)
    big_v = torch.randn(2 * n_pages - 1, hkv, PAGE, hd, generator=gen,
                        device=dev).to(bf16)
    big_table = torch.from_numpy(np.random.default_rng(2).permutation(
        np.arange(1, 2 * SLOTS * MAX_PAGES + 1)).reshape(
        SLOTS, 2 * MAX_PAGES).astype(np.int32)).to(dev)
    cases = [(*c, k_pages, v_pages) for c in paged_cases(cfg, dev, gen)]
    cases.append(("verify_splits", torch.randn(
        SLOTS, hkv, g * SPEC_TOKENS, hd, generator=gen, device=dev).to(bf16),
        big_table, torch.tensor([900, 930, 960, 980, 1000, 1010, 1020,
                                 1024], dtype=torch.int32, device=dev),
        SPEC_TOKENS, big_k, big_v))
    for name, q, table, lengths, t, k_pages, v_pages in cases:
        row, kernel, got, want = paged_row(name, q, table, lengths, t,
                                           k_pages, v_pages, timer)
        if name == "decode":
            # shared split body: page 64 == BLOCK_KV and T = 1 give the
            # contiguous kernel's bits over the gathered pages
            dense = flash_decode(q, kvc.gather_pages(k_pages, table),
                                 kvc.gather_pages(v_pages, table), lengths)
            torch.cuda.synchronize()
            if not torch.equal(got, dense):
                raise AssertionError("flash_decode_paged differs from "
                                     "flash_decode over the gathered pages")
            row["bitwise_vs_flash_decode"] = True
        b = q.shape[0]
        rows.append(row)
        if name.startswith("verify"):
            units = attn_decode.decode_units(b, hkv, g * t, t)
            splits = attn_decode.plan_decode(
                units, table.shape[1] * PAGE // attn_decode.KEY_TILE,
                gemm_ops.sm_count(dev))[0]
            # also at 8 q (exact in bf16): scores of a few units, whose
            # running maxima in log2 units do not round back exactly
            holds, diff = True, 0.0
            for f in (1, 8):
                h_, d_ = verify_serial_bits(
                    f"flash_decode_paged[{name}] ({splits} split(s), q x{f})",
                    lambda q_, l_, t_: flash_decode_paged(
                        q_, k_pages, v_pages, table, l_, q_tokens=t_),
                    q * f, lengths, t, g)
                holds, diff = holds and h_, max(diff, d_)
            rows[-1].update(verify_rows_bitwise=holds,
                            verify_rows_max_diff=diff, splits=splits)
            if splits == 1 and not holds:
                raise AssertionError(
                    f"flash_decode_paged[{name}]: at one split a verify row "
                    f"differs from the serial call by {diff:.4g}")
        if old is not None and old["flash_decode_paged_same"] is not None:
            def old_fn(q=q, k_pages=k_pages, v_pages=v_pages, table=table,
                       lengths=lengths, t=t):
                return attn_decode._launch_paged(
                    q, k_pages, v_pages, table, lengths, window=None,
                    scale=scale, softcap=None, q_tokens=t, sinks=None,
                    kernel=old["flash_decode_paged_same"])
            decode_turns(rows[-1], f"flash_decode_paged[{name}]", old_fn,
                         kernel, want, timer)
        elif old is not None and old["flash_decode_paged"] is not None:
            decode_turns(rows[-1], f"flash_decode_paged[{name}]",
                         baseline_decode_paged(old["flash_decode_paged"], q,
                                               k_pages, v_pages, table,
                                               lengths, t), kernel, want,
                         timer)
    return rows


def train_gemm_cases(cfg, dev, gen):
    """One layer's four fused GEMMs at the training shape (M = 4 x 1024
    tokens): q|k (+rope) and v behind the rmsnorm prologue, the SwiGLU up
    projection, the down projection with its scaled residual; and rung 2's
    q|k GEMM without the rope store."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    nqk = (cfg.num_heads + cfg.num_kv_heads) * hd
    m = TRAIN_BATCH * TRAIN_SEQ
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)

    gamma = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(bf16)
    rms = dict(prologue=Prologue(norm="rmsnorm"), gamma=gamma)
    sin, cos = rope_tables(torch.arange(TRAIN_SEQ, device=dev), hd,
                           cfg.rope_theta)
    x = rnd(m, d)
    wd, wf = d ** -0.5, f ** -0.5
    cases = [
        ("qk_rope", x, rnd(d, nqk, std=wd),
         dict(epilogue=Epilogue(rope=True, head_dim=hd),
              sin=sin.repeat(TRAIN_BATCH, 1), cos=cos.repeat(TRAIN_BATCH, 1),
              **rms)),
        ("v", x, rnd(d, cfg.num_kv_heads * hd, std=wd), dict(**rms)),
        ("swiglu_up", x, rnd(d, f, std=wd),
         dict(epilogue=Epilogue(activation="silu", gate=True),
              b2=rnd(d, f, std=wd), **rms)),
        ("down", rnd(m, f), rnd(f, d, std=wf),
         dict(epilogue=Epilogue(residual=True, scale=True),
              residual=rnd(m, d), scale=1.0)),
    ]
    # the ladder's rung 2 (phase 7b): the q|k GEMM without the rope store
    return cases + [("qk", x, cases[0][2], dict(**rms))]


# the training GEMMs of bert-110m (8 x 512 tokens) and whisper-base (the
# encoder over 4 x 1500 frames, the decoder over 4 x 448 tokens), phases 9c
# and 9d: name -> (M, K, N, layernorm + beta?, epilogue kwargs); a relu and
# a geglu chain at bert's shape, which no path runs
ENCODER_TRAIN_GEMMS = {
    **{f"{model}_{name}": (m, *dims)
       for model, m, d, f in (("bert", 4096, 768, 3072),
                              ("whisper_enc", 6000, 512, 2048),
                              ("whisper_dec", 1792, 512, 2048))
       for name, dims in (("qk", (d, 2 * d, True, {})),
                          ("v", (d, d, True, {})),
                          ("up_gelu", (d, f, True, dict(activation="gelu"))),
                          ("down", (f, d, False,
                                    dict(residual=True, scale=True))))},
    "bert_up_relu": (4096, 768, 3072, True, dict(activation="relu")),
    "bert_up_geglu": (4096, 768, 3072, True,
                      dict(activation="gelu", gate=True)),
}


def moe_train_gemm_cases(dev, gen):
    """mixtral-8x7b's training GEMMs (phase 13) at M = TRAIN_BATCH x
    TRAIN_SEQ as (name, a, b, kwargs): q|k (+ rope, head_dim 128) and v on
    the rmsnorm prologue, an expert's dual-output silu-gated up projection
    with no prologue (2 x N 14336) and its down projection with no epilogue
    (K 14336). The weights at std K^-1/2."""
    cfg = get_config(MOE_ARCH)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    m = TRAIN_BATCH * TRAIN_SEQ
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)

    rms = dict(prologue=Prologue(norm="rmsnorm"),
               gamma=(1 + 0.1 * torch.randn(d, generator=gen,
                                            device=dev)).to(bf16))
    sin, cos = rope_tables(torch.arange(TRAIN_SEQ, device=dev), hd,
                           cfg.rope_theta)
    x = rnd(m, d)
    wd = d ** -0.5
    return [
        ("mixtral_qk_rope", x,
         rnd(d, (cfg.num_heads + cfg.num_kv_heads) * hd, std=wd),
         dict(epilogue=Epilogue(rope=True, head_dim=hd),
              sin=sin.repeat(TRAIN_BATCH, 1), cos=cos.repeat(TRAIN_BATCH, 1),
              **rms)),
        ("mixtral_v", x, rnd(d, cfg.num_kv_heads * hd, std=wd), dict(**rms)),
        ("mixtral_expert_up", x, rnd(d, f, std=wd),
         dict(epilogue=Epilogue(activation="silu", gate=True),
              b2=rnd(d, f, std=wd))),
        ("mixtral_expert_down", rnd(m, f), rnd(f, d, std=f ** -0.5), {}),
    ]


def rg_train_gemm_cases(dev, gen):
    """recurrentgemma-2b's training GEMMs (phase 16) as (name, a, b,
    kwargs): ``rg_gemm_cases``' rows at M = RG_TRAIN_BATCH x RG_TRAIN_SEQ
    (q|k N 2816 and v N 256 on the rmsnorm prologue, the geglu up, its
    gated gelu from two saved preacts, and the down K 7680 with the
    residual)."""
    return [c[:4] for c in rg_gemm_cases(dev, gen)
            if c[0].startswith("rg_train_")]


def encoder_train_gemm_cases(dev, gen):
    """ENCODER_TRAIN_GEMMS as (name, a, b, kwargs): the weights at std
    K^-1/2, gamma about 1, beta at std 0.5."""
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)

    cases = []
    for name, (m, k, n, ln, ep_kw) in ENCODER_TRAIN_GEMMS.items():
        kw = {"epilogue": Epilogue(**ep_kw)}
        if ln:
            kw.update(prologue=Prologue(norm="layernorm", beta=True),
                      gamma=(1 + 0.1 * torch.randn(
                          k, generator=gen, device=dev)).to(bf16),
                      beta=rnd(k, std=0.5))
        if ep_kw.get("gate"):
            kw["b2"] = rnd(k, n, std=k ** -0.5)
        if ep_kw.get("residual"):
            kw.update(residual=rnd(m, n), scale=1.0)
        cases.append((name, rnd(m, k), rnd(k, n, std=k ** -0.5), kw))
    return cases


def baseline_da(kern, run):
    """A launch of the earlier dA (its entry point takes no mean and no
    dbeta partials; the rmsnorm and plain chains) on ``run``'s
    operand-pass buffers, into its outputs, then the sum of its dgamma
    partials, as ``run.da`` does; its launches are not counted."""
    if kern.argtypes == gemm_bwd.DA_KERNEL.argtypes:
        return lambda: run.da(kernel=kern)

    def launch():
        kern.check(kern.fn()(
            run.gbar.data_ptr(), run.b, run.b2,
            run.a if run.norm else None, run.gamma, run.rstd,
            run._ptr(run.dan), run.da_out.data_ptr(),
            run._ptr(run.dgamma_part), run.m, run.n, run.k, run.tile_da, 3,
            torch.cuda.current_stream().cuda_stream))
        return run._sum(run.dgamma_part)
    return launch


def measure_gemm_bwd(cfg, dev, gen, timer, old=None, cases=None,
                     sweep_widths: bool = True):
    """The GEMM backward of each training GEMM, from the forward's saved
    statistics and preacts and a random cotangent, as its three launches:
    the operand pass (``gemm_bwd_g``), dA (the GEMM, and the norm row pass
    timed apart, with its own bytes bound: dAn, A, the statistics and gamma
    read, dA and the dgamma and dbeta partials written) and dB, each
    against its plain version at the forward's statistics; at llama-1b's
    training shapes, at ENCODER_TRAIN_GEMMS, at mixtral-8x7b's
    (``moe_train_gemm_cases``), at recurrentgemma-2b's
    (``rg_train_gemm_cases``) and at internvl2-2b's
    (``ivl_train_gemm_cases``). Bounds: the
    operand pass by its bytes (g, preacts, tables, A, gamma, beta and the
    statistics read; gbar, gbar_t, a_t written once); dA and dB by their own operands and
    outputs, or 2 M N K operations per product at the bf16 peak. Library
    yardstick: torch.matmul of the bare product (g @ Bᵀ, Aᵀ @ g; the gated
    chain's two products as one concatenated one). Also the whole backward
    (operand pass + dA + dB through ``gemm_fused_bwd``) against the
    library's two products, bound by the chain's inputs and outputs or both
    products. With ``old`` (baseline_kernels), the earlier tree's dA + dB
    on the same operand-pass buffers, which must give this tree's bits, in
    turns with this tree's dA + dB (baseline, new, new, baseline), on the
    chains the baseline takes. ``cases``: others than these (phase 22b's);
    ``sweep_widths`` False times the picked tile widths only."""
    rows = {"gemm_bwd_g": [], "gemm_bwd_da": [], "gemm_bwd_db": []}
    whole = []
    if cases is None:
        cases = (train_gemm_cases(cfg, dev, gen)
                 + encoder_train_gemm_cases(dev, gen)
                 + moe_train_gemm_cases(dev, gen)
                 + rg_train_gemm_cases(dev, gen)
                 + ivl_train_gemm_cases(dev, gen))
    for name, a, b, kw in cases:
        ep = kw.get("epilogue", EPILOGUE_NONE)
        pro = kw.get("prologue", PROLOGUE_NONE)
        _, rstd, preacts = gemm_forward(
            a, b, ep, pro, b2=kw.get("b2"), bias=None,
            residual=kw.get("residual"), scale=kw.get("scale"),
            sin=kw.get("sin"), cos=kw.get("cos"), gamma=kw.get("gamma"),
            beta=kw.get("beta"), out_dtype=torch.bfloat16,
            save_preact=gemm_ops.kernel_saves(ep) > 0)
        m, k = a.shape
        n = b.shape[1]
        g = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
        ops = dict(epilogue=ep, prologue=pro, b2=kw.get("b2"), bias=None,
                   scale=kw.get("scale"), sin=kw.get("sin"), cos=kw.get("cos"),
                   gamma=kw.get("gamma"), beta=kw.get("beta"), rstd=rstd,
                   preacts=preacts)
        g_ops = {x: v for x, v in ops.items() if x != "b2"}
        run = gemm_bwd.BwdLaunch(a, b, g, **ops)
        norm = run.norm

        run.operand_pass()
        da, dgamma, dbeta = run.da()
        db, db2 = run.db()
        want_g = gemm_bwd.gemm_bwd_g_ref(a, g, **g_ops)
        want_da, want_dgamma, want_dbeta = gemm_bwd.gemm_bwd_da_ref(
            a, b, g, **ops)
        want_db, want_db2, _ = gemm_bwd.gemm_bwd_db_ref(a, b, g, **ops)
        torch.cuda.synchronize()
        # the operand pass: one bf16 rounding of the same fp32 value
        err_g, tol_g = check_close(f"gemm_bwd_g[{name}]", run.gbar,
                                   want_g["gbar"], 2 ** -7, 1e-6)
        if not (torch.equal(run.gbar_t[:, :m], run.gbar.T)
                and torch.equal(run.a_t[:, :m].float(), want_g["a_t"])):
            raise AssertionError(f"gemm_bwd_g[{name}]: gbar_t is not gbar's "
                                 "transpose, or a_t not the plain An^T")
        tol = 2 ** -6, 2e-2
        err_a, tol_s = check_close(f"gemm_bwd_da[{name}]", da, want_da, *tol)
        for part, got_p, want_p in (("dgamma", dgamma, want_dgamma),
                                    ("dbeta", dbeta, want_dbeta)):
            if (got_p is None) != (want_p is None):
                raise AssertionError(f"gemm_bwd_da[{name}]: {part} missing")
            if got_p is not None:
                err_a = max(err_a, check_close(
                    f"gemm_bwd_da[{name}].{part}", got_p, want_p, 1e-3,
                    1e-3)[0])
        err_b, _ = check_close(f"gemm_bwd_db[{name}]", db, want_db, *tol)
        if db2 is not None:
            err_b = max(err_b, check_close(f"gemm_bwd_db[{name}].db2", db2,
                                           want_db2, *tol)[0])
        del want_g, want_da, want_db, want_db2
        gated = ep.gate
        flops = 2 * m * n * k * (2 if gated else 1)
        g_in = nbytes(g, *preacts, kw.get("sin"), kw.get("cos"))
        a_in = nbytes(a, kw.get("gamma"), kw.get("beta"), rstd)
        n2 = run.gbar.shape[1]
        g_out = 2 * m * n2 * 2 + k * m * 2          # gbar, gbar_t, a_t
        da_in = nbytes(run.gbar, b, kw.get("b2")) + (a_in if norm else 0)
        db_in = 2 * (k * m + n2 * m)                 # a_t, gbar_t
        out_da, out_db = nbytes(da, dgamma, dbeta), nbytes(db, db2)
        g_lib = torch.cat([g, g], dim=1) if gated else g
        b_lib = torch.cat([b, kw["b2"]], dim=1) if gated else b

        def lib_da():
            return torch.matmul(g_lib, b_lib.T)

        def lib_db():
            return torch.matmul(a.T, g_lib)

        def lib_both():
            return lib_da(), lib_db()

        def new_whole():
            return gemm_bwd.gemm_fused_bwd(a, b, g, **ops)

        shape = [m, k, n]
        b_ms, b_by = bound(g_in + a_in + g_out)
        rows["gemm_bwd_g"].append(dict(
            case=name, shape=shape, max_abs_err=err_g, tolerance=tol_g,
            ms=timer.ms(run.operand_pass),
            plain_ms=timer.ms(lambda: gemm_bwd.gemm_bwd_g_ref(a, g,
                                                              **g_ops)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
        b_ms, b_by = bound(da_in + out_da, (flops, PEAK_BF16))
        da_row = dict(
            case=name, shape=shape, max_abs_err=err_a, tolerance=tol_s,
            ms=timer.ms(run.da),
            plain_ms=timer.ms(lambda: gemm_bwd.gemm_bwd_da_ref(a, b, g,
                                                               **ops)),
            library_ms=timer.ms(lib_da), bound_ms=b_ms, bound_by=b_by,
            gemm_ms=timer.ms(lambda: run.da(passes=1)))
        if norm:
            # the row pass with the sums of its partials
            da_row["row_pass_ms"] = timer.ms(lambda: run.da(passes=2))
            da_row["row_pass_bound_ms"] = bound(
                nbytes(run.dan, a, da, kw.get("gamma"), rstd,
                       run.dgamma_part, run.dbeta_part))[0]
        if pro.norm == "layernorm":
            # what layernorm's second row mean and dbeta cost: the rmsnorm
            # pass on the same buffers (its rstd the layernorm's)
            ln_mean, ln_dbeta = run.mean, run.dbeta_part
            run.mean, run.dbeta_part = None, None
            da_row["row_pass_rmsnorm_ms"] = timer.ms(
                lambda: run.da(passes=2))
            run.mean, run.dbeta_part = ln_mean, ln_dbeta
        rows["gemm_bwd_da"].append(da_row)
        b_ms, b_by = bound(db_in + out_db, (flops, PEAK_BF16))
        rows["gemm_bwd_db"].append(dict(
            case=name, shape=shape, max_abs_err=err_b, tolerance=tol_s,
            ms=timer.ms(run.db),
            plain_ms=timer.ms(lambda: gemm_bwd.gemm_bwd_db_ref(a, b, g,
                                                               **ops)),
            library_ms=timer.ms(lib_db), bound_ms=b_ms, bound_by=b_by))
        # each tile width of the mainloop, against the one picked
        by_width = {}
        for width in gemm_bwd.TILE_WIDTHS if sweep_widths else ():
            sweep = gemm_bwd.BwdLaunch(a, b, g, tile_n=width, **ops)
            sweep.operand_pass()
            by_width[width] = (timer.ms(lambda: sweep.da(passes=1)),
                               timer.ms(sweep.db))
            del sweep
        da_row.update(tile_n=run.tile_da, gemm_ms_by_tile_n={
            w: t[0] for w, t in by_width.items()})
        rows["gemm_bwd_db"][-1].update(tile_n=run.tile_db, ms_by_tile_n={
            w: t[1] for w, t in by_width.items()})
        us = {w: [round(x * 1e3, 1) for x in t] for w, t in by_width.items()}
        log(f"[kernel] gemm_bwd[{name}] by tile width, (dA GEMM, dB) us: "
            f"{us}; picked {run.tile_da} for dA, {run.tile_db} for dB")
        b_ms, b_by = bound(g_in + a_in + nbytes(b, kw.get("b2")) + out_da
                           + out_db, (2 * flops, PEAK_BF16))
        w = dict(case=name, shape=shape, ms=timer.ms(new_whole),
                 library_ms=timer.ms(lib_both), bound_ms=b_ms, bound_by=b_by)
        if old is not None and pro.norm != "layernorm" and \
                old["da"] is not None and old["db"] is not None:
            old_da = baseline_da(old["da"], run)

            def new_both():
                run.da()
                run.db()

            def old_both():
                old_da()
                run.db(kernel=old["db"])

            new_both()
            mine = [t.clone() for t in (run.da_out, run.db_out)]
            old_both()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in
                       zip(mine, (run.da_out, run.db_out))):
                raise AssertionError(f"gemm_bwd[{name}]: dA or dB differs "
                                     "from the baseline's bits")
            del mine
            turns = [timer.ms(old_both), timer.ms(new_both),
                     timer.ms(new_both), timer.ms(old_both)]
            w["baseline_turns_ms"] = turns     # baseline, new, new, baseline
            w["baseline_ms"] = (turns[0] + turns[3]) / 2
            w["new_in_turns_ms"] = (turns[1] + turns[2]) / 2
        whole.append(w)
        log(f"[kernel] gemm_fused_bwd[{name}] whole backward "
            f"{w['ms'] * 1e3:.1f} us (operand pass "
            f"{rows['gemm_bwd_g'][-1]['ms'] * 1e3:.1f}, dA GEMM "
            f"{da_row['gemm_ms'] * 1e3:.1f}, row pass "
            f"{da_row.get('row_pass_ms', 0.0) * 1e3:.1f}"
            + (f" (on rmsnorm {da_row['row_pass_rmsnorm_ms'] * 1e3:.1f}, "
               f"bound {da_row['row_pass_bound_ms'] * 1e3:.2f})"
               if "row_pass_rmsnorm_ms" in da_row else "")
            + f", dB "
            f"{rows['gemm_bwd_db'][-1]['ms'] * 1e3:.1f}); library products "
            f"{w['library_ms'] * 1e3:.1f} us; bound "
            f"{w['bound_ms'] * 1e3:.2f} us ({w['bound_by']})"
            + (f"; baseline dA + dB {w['baseline_ms'] * 1e3:.1f} us against "
               f"{w['new_in_turns_ms'] * 1e3:.1f} in turns"
               if "baseline_ms" in w else ""))
        del run, preacts, g, g_lib, b_lib, da, db, db2, dgamma, dbeta
    return rows, whole


def baseline_flash_bwd(kern, args):
    """The earlier two-pass flash backward (its own entry point: dq, dk, dv
    written by a dq pass and a dk/dv pass, no workspace) as one callable
    on the training case's causal inputs, delta computed as the wrapper
    computes it; its launches are not counted."""
    q, k, v, out, lse, do = args
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    lse32 = lse.float().contiguous()
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, hkv, skv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)

    def launch():
        delta = attn_bwd.attention_delta(out, do).contiguous()
        for which in (0, 1):
            kern.check(kern.fn()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse32.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), which, b, h, hkv, sq, skv, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *do.stride()[:3], float(d ** -0.5), 0.0, 1, 0,
                torch.cuda.current_stream().cuda_stream))
        return dq, dk, dv
    return launch


def flash_bwd_cases(cfg) -> dict:
    """The flash backward's shapes: name -> (B, H, Hkv, Sq, Skv, causal,
    head_dim): llama-1b's training (phase 6b), bert-110m's (9c),
    whisper-base's encoder over 1500 frames (a ragged last key tile), its
    decoder's causal self attention and its cross attention of 448 queries
    over 1500 frames (9d), at head_dim 64; mixtral-8x7b's training (13),
    B 4, H 32, Hkv 8, S 1024 at head_dim 128 (its 4096-token window holds
    the whole sequence: the causal mask's pairs); internvl2-2b's (19), B 4,
    H 16, Hkv 8, S 2048 at head_dim 128."""
    moe, ivl = get_config(MOE_ARCH), get_config(IVL_ARCH)
    return {"train_causal_gqa": (TRAIN_BATCH, cfg.num_heads, cfg.num_kv_heads,
                                 TRAIN_SEQ, TRAIN_SEQ, True, cfg.head_dim),
            "bert": (B_BATCH, 12, 12, B_SEQ, B_SEQ, False, 64),
            "whisper_enc": (W_TRAIN_BATCH, 8, 8, 1500, 1500, False, 64),
            "whisper_dec": (W_TRAIN_BATCH, 8, 8, W_TRAIN_SEQ, W_TRAIN_SEQ,
                            True, 64),
            "whisper_cross": (W_TRAIN_BATCH, 8, 8, W_TRAIN_SEQ, 1500, False,
                              64),
            "mixtral_train": (TRAIN_BATCH, moe.num_heads, moe.num_kv_heads,
                              TRAIN_SEQ, TRAIN_SEQ, True, moe.head_dim),
            "ivl_train": (IVL_TRAIN_BATCH, ivl.num_heads, ivl.num_kv_heads,
                          IVL_TRAIN_SEQ, IVL_TRAIN_SEQ, True, ivl.head_dim)}


def measure_flash_bwd(cfg, dev, gen, timer, old=None):
    """The flash backward at each of :func:`flash_bwd_cases`, q and
    k as views of the packed q|k output where the attention is a
    self-attention (else projections of their own, as the cross
    attention's plain products give them), dO as the strided cotangent
    autograd hands over, against the plain version. The whole backward
    (``flash_attention_bwd`` as the model calls it: delta,
    the zeroed dq workspace, the main kernel and the dq conversion) is
    bound by the five products per visible (q, k) pair (s, dp, dv, dk, dq)
    or by q, k, v, dO, lse and delta read and dq, dk, dv written once; the
    main kernel (timed apart on prepared buffers) by the same products or
    its bytes with the fp32 workspace written once; the conversion by the
    workspace read and dq written; the plain-torch delta and the
    workspace's zeroing are timed apart too. Yardstick: torch.autograd.grad through
    F.scaled_dot_product_attention, the forward not timed, captured in a
    CUDA graph on the stream that ran the forward (autograd runs each
    backward op on its forward's stream) and replayed like every other
    call; its dq, dk, dv are held to the plain version first. With ``old``
    (baseline_kernels), the earlier two-pass kernel at llama's training
    shape, held to the plain version, in turns with this one (baseline,
    new, new, baseline)."""
    bf16 = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    rows = []
    for case, (bsz, h, hkv, sq, skv, causal,
               hd) in flash_bwd_cases(cfg).items():
        if sq == skv:
            qk = rnd(bsz, sq, (h + hkv) * hd)
            q = qk[..., : h * hd].reshape(bsz, sq, h, hd).transpose(1, 2)
            k = qk[..., h * hd:].reshape(bsz, sq, hkv, hd).transpose(1, 2)
        else:
            q = rnd(bsz, sq, h * hd).reshape(bsz, sq, h, hd).transpose(1, 2)
            k = rnd(bsz, skv, hkv * hd).reshape(bsz, skv, hkv,
                                                hd).transpose(1, 2)
        v = rnd(bsz, skv, hkv * hd).reshape(bsz, skv, hkv, hd).transpose(1, 2)
        do = rnd(bsz, sq, h, hd).transpose(1, 2)
        rows.append(flash_bwd_row(case, q, k, v, do, causal, timer,
                                  old if case == "train_causal_gqa"
                                  else None))
        del q, k, v, do
    return rows


def measure_rg_flash_bwd(dev, gen, timer) -> list:
    """Phase 16a: the flash backward at head_dim 256, recurrentgemma-2b's
    10 query heads over one kv head, against its plain version as phase
    3's rows are held (``flash_bwd_row``): at phase 16's training shape,
    B RG_TRAIN_BATCH, S RG_TRAIN_SEQ causal in the 2048-token window, and
    at B 4, S 1024 causal with no window; q and k views of the packed q|k
    projection, v of its own, dO the strided cotangent."""
    cfg = get_config(RG_ARCH)
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bf16 = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    rows = []
    for case, bsz, seq, window in (
            ("rg_train_window", RG_TRAIN_BATCH, RG_TRAIN_SEQ,
             cfg.rglru.local_window), ("rg_s1024", 4, 1024, None)):
        qk = rnd(bsz, seq, (h + hkv) * hd)
        q = qk[..., : h * hd].reshape(bsz, seq, h, hd).transpose(1, 2)
        k = qk[..., h * hd:].reshape(bsz, seq, hkv, hd).transpose(1, 2)
        v = rnd(bsz, seq, hkv * hd).reshape(bsz, seq, hkv, hd).transpose(1, 2)
        do = rnd(bsz, seq, h, hd).transpose(1, 2)
        r = flash_bwd_row(case, q, k, v, do, True, timer, window=window)
        log(f"[16a] flash_attention_bwd[{case}] head_dim 256: whole "
            f"{r['ms'] * 1e3:.1f} us (main {r['main']['ms'] * 1e3:.1f}, "
            f"delta {r['delta_ms'] * 1e3:.1f}, zeroing "
            f"{r['zero_ms'] * 1e3:.1f}, conversion "
            f"{r['convert']['ms'] * 1e3:.1f}), plain "
            f"{r['plain_ms'] * 1e3:.1f} us, SDPA backward "
            f"{r['library_ms'] * 1e3:.1f} us, bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}); timer floor "
            f"{timer.floor() * 1e3:.2f} us")
        rows.append(r)
        del q, k, v, do, qk
    return rows


def flash_bwd_truth(args, causal, window=None):
    """(dq, dk, dv) of the plain version in fp32 throughout: its inputs
    upcast, so p and ds are not rounded to bf16 before their products."""
    q, k, v, out, lse, do = args
    f = lambda t: t.float()
    return flash_attention_bwd_ref(f(q), f(k), f(v), f(out), lse, f(do),
                                   causal=causal, window=window)


# entries of one flash-backward gradient that the fp32 truth may decide
# where the kernel and its plain version disagree: the most this script's
# draws have shown on an H100 (llama's dq, 1 of 8.4M)
TRUTH_TAIL = 1


def dq_ds_ties(args, causal, ix, ulps: float = 8.0, window=None) -> list:
    """The keys of dq entry ``ix``'s row whose ds (fp64, from the bf16
    inputs and the saved lse) lies within ``ulps`` fp32 ulps of a midpoint
    between two bf16 values, where two correct fp32 versions may round it
    to other neighbours; each with the shift of the dq entry that the
    other neighbour gives (one bf16 ulp of ds times k). [{key, ds, ulps
    from the midpoint, shift}]."""
    q, k, v, out, lse, do = args
    b, hh, i, c = ix
    h, hkv, d = q.shape[1], k.shape[1], q.shape[-1]
    hk = hh // (h // hkv)
    n = i + 1 if causal else k.shape[2]
    lo = max(0, i - window + 1) if window else 0   # the window's first key
    f = torch.float64
    kk, vv = k[b, hk, lo:n].to(f), v[b, hk, lo:n].to(f)
    p = torch.exp(kk @ q[b, hh, i].to(f) * d ** -0.5 - lse[b, hh, i].to(f))
    delta = (do[b, hh, i].to(f) * out[b, hh, i].to(f)).sum()
    ds = p * (vv @ do[b, hh, i].to(f) - delta) * d ** -0.5
    e = torch.floor(torch.log2(ds.abs().clamp_min(1e-30)))
    ulp = torch.exp2(e - 7)                     # bf16: 8 significant bits
    dist = (ds - (torch.floor(ds / ulp) + 0.5) * ulp).abs() / torch.exp2(
        e - 23)                                 # in fp32 ulps
    return [dict(key=lo + j, ds=ds[j].item(), ulps=dist[j].item(),
                 shift=(ulp[j] * kk[j, c]).item())
            for j in (dist <= ulps).nonzero().flatten().tolist()]


def check_close_to_truth(name, got, want, rtol, atol_frac, truth,
                         ties=None):
    """:func:`check_close` of a bf16 gradient against its plain version,
    and, only where that fails, the fp32 truth (``truth()``) deciding by
    a rule stated here. The two versions round ds to bf16 at the same
    points but from other fp32 values (the kernel's exp is
    ``ex2.approx``, its sums run in another order), so an unrounded ds
    within a few fp32 ulps of a midpoint between two bf16 values rounds
    apart; at an early causal row, whose dq sums a few keys, one such ds
    times its k moves a small dq entry past the tolerance (on an H100,
    llama's dq[0, 24, 9, 19]: row 9, ds at key 7 3 fp32 ulps above a
    midpoint, the two 2^-10 x 2.34375 apart; the plain version itself is
    outside the same tolerance of the truth at 11-47 entries of a
    tensor). The rule: at most TRUTH_TAIL entries outside the tolerance
    of the plain version, each within the same tolerance of the truth
    (rtol |truth| + atol_frac x rms(truth)), and the whole tensor within
    phase 6a's bound of the truth (its max distance at most 2x the plain
    version's + 1e-3). ``ties`` (an index -> :func:`dq_ds_ties`) reports
    each such entry's ds near a bf16 midpoint. Returns (max abs err
    against the plain version, the tolerance's description, the entries
    the truth decided)."""
    try:
        err, tol = check_close(name, got, want, rtol, atol_frac)
        return err, tol, 0
    except AssertionError:
        if not torch.isfinite(got).all():
            raise
    g, w = got.float(), want.float()
    atol = atol_frac * w.pow(2).mean().sqrt().item()
    bad = (g - w).abs() > rtol * w.abs() + atol
    t = truth().float()
    t_atol = atol_frac * t.pow(2).mean().sqrt().item()
    off = bad & ((g - t).abs() > rtol * t.abs() + t_atol)
    plain_off = int(((w - t).abs() > rtol * t.abs() + t_atol).sum())
    k_max, p_max = ((x - t).abs().max().item() for x in (g, w))
    entries = [dict(index=ix, kernel=g[tuple(ix)].item(),
                    plain=w[tuple(ix)].item(), truth=t[tuple(ix)].item(),
                    **({} if ties is None else {"ties": ties(ix)}))
               for ix in bad.nonzero()[:4].tolist()]
    n_bad = int(bad.sum())
    if n_bad > TRUTH_TAIL or off.any() or not k_max <= 2 * p_max + 1e-3:
        raise AssertionError(
            f"{name}: {n_bad} of {bad.numel()} elements outside rtol {rtol} "
            f"+ atol {atol:.3g} of the plain version (the truth decides "
            f"{TRUTH_TAIL} at most), {int(off.sum())} of them outside the "
            f"same tolerance of the fp32 truth ({entries}); the kernel's max "
            f"distance from the truth {k_max:.4g}, the plain version's "
            f"{p_max:.4g}")
    log(f"[kernel] {name}: {n_bad} of {bad.numel()} elements outside the "
        f"tolerance of the plain version, within it of the fp32 truth "
        f"({entries}); max distance from the truth {k_max:.4g}, the plain "
        f"version's {p_max:.4g}; the plain version outside the same "
        f"tolerance of the truth at {plain_off} entries")
    return ((g - w).abs().max().item(),
            f"rtol {rtol:g} + {atol_frac:g} x rms of the plain version, or "
            f"of the fp32 truth at {TRUTH_TAIL} entry at most", n_bad)


def window_mask(sq, skv, causal, window, dev):
    """The plain version's mask as SDPA's boolean ``attn_mask``: query i
    sees key j iff i - j < window (and j <= i where causal)."""
    qpos = torch.arange(sq, device=dev)[:, None]
    kpos = torch.arange(skv, device=dev)[None, :]
    mask = qpos - kpos < window
    if causal:
        mask &= qpos >= kpos
    return mask


def flash_bwd_row(case, q, k, v, do, causal, timer, old=None,
                  window=None) -> dict:
    """One row of :func:`measure_flash_bwd` (and of phase 16a's, with a
    ``window``: SDPA's yardstick then takes it as an explicit mask)."""
    bsz, h, seq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    args = (q, k, v, out, lse, do)
    opts = dict(causal=causal, window=window, logit_scale=None, softcap=None)
    masks = (dict(is_causal=causal) if window is None else
             dict(attn_mask=window_mask(seq, skv, causal, window, q.device)))

    def kernel():
        return attn_bwd.flash_attention_bwd(*args, **opts)

    qc, kc, vc = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
    doc = do.contiguous()
    lib_stream = torch.cuda.Stream()
    lib_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(lib_stream):
        ref_out = F.scaled_dot_product_attention(qc, kc, vc, enable_gqa=True,
                                                 **masks)

    def library():
        return torch.autograd.grad(ref_out, (qc, kc, vc), doc,
                                   retain_graph=True)

    with torch.cuda.stream(lib_stream):
        lib = library()
    torch.cuda.current_stream().wait_stream(lib_stream)
    got = kernel()
    want = flash_attention_bwd_ref(*args, causal=causal, window=window)
    old_fn = (None if old is None or old["flash_bwd"] is None
              else baseline_flash_bwd(old["flash_bwd"], args))
    old_got = None if old_fn is None else old_fn()
    torch.cuda.synchronize()
    err = 0.0
    lib_err = {}
    decided = {}
    for i, name in enumerate(("dq", "dk", "dv")):
        w_ = want[i]
        e, tol, decided[name] = check_close_to_truth(
            f"flash_attention_bwd[{case}][{name}]", got[i], w_, 2e-2, 2e-2,
            lambda i=i: flash_bwd_truth(args, causal, window)[i],
            (lambda ix: dq_ds_ties(args, causal, ix, window=window))
            if i == 0 else None)
        err = max(err, e)
        if old_got is not None:   # the baseline computes the same function
            check_close(f"baseline flash_attention_bwd[{name}]", old_got[i],
                        w_, 2e-2, 2e-2)
        # the yardstick computes the same function. It rounds at other
        # points than the plain version (which are the kernel's), and on an
        # H100 a few entries of millions miss the kernel's elementwise
        # tolerance (dq 1 of 8.4M, dk 1-15 of 2.1M, by up to 0.031), so it
        # is held to the plain version in norm, 1% of it, and the entries
        # outside the kernel's tolerance are counted
        lf, wf = lib[i].float(), w_.float()
        if not torch.isfinite(lf).all():
            raise AssertionError(f"sdpa backward[{case}][{name}]: non-finite")
        diff = lf - wf
        rel = (diff.norm() / wf.norm()).item()
        if rel > 1e-2:
            raise AssertionError(f"sdpa backward[{case}][{name}]: {rel:.3g} "
                                 "of the plain version's norm away")
        atol = 2e-2 * wf.pow(2).mean().sqrt().item()
        lib_err[name] = dict(
            relative_norm_err=rel, max_abs_err=diff.abs().max().item(),
            outside_kernel_tolerance=int(
                (diff.abs() > 2e-2 * wf.abs() + atol).sum()))
        del lf, wf, diff
    del got, want, lib, old_got
    work = attn_bwd.backward_work(bsz, h, hkv, seq, skv, hd, causal=causal,
                                  window=window)
    products = (work["flops"], PEAK_BF16)
    b_ms, b_by = bound(work["bytes"], products)
    main_ms, main_by = bound(work["main_bytes"], products)
    conv_ms, _ = bound(work["convert_bytes"])
    run = attn_bwd.FlashBwdLaunch(*args, **opts)
    row = dict(
        case=case, shape=[bsz, h, hkv, seq, skv, hd], causal=causal,
        max_abs_err=err, tolerance=tol, decided_by_truth=decided,
        ms=timer.ms(kernel),
        plain_ms=timer.ms(lambda: flash_attention_bwd_ref(
            *args, causal=causal, window=window)),
        library_ms=timer.ms(library, stream=lib_stream),
        library_vs_plain=lib_err, bound_ms=b_ms, bound_by=b_by,
        main=dict(replaces=["src/repro/kernels/attention/kernel_bwd.py:71",
                            "src/repro/kernels/attention/kernel_bwd.py:114"],
                  ms=timer.ms(run.main), bound_ms=main_ms,
                  bound_by=main_by),
        convert=dict(ms=timer.ms(run.convert), bound_ms=conv_ms,
                     bound_by="bytes"),
        # the whole's plain-torch parts: delta and the workspace's zeroing
        delta_ms=timer.ms(lambda: attn_bwd.attention_delta(out, do)),
        zero_ms=timer.ms(lambda: torch.zeros_like(run.dq_acc)))
    if window is not None:
        row["window"] = window
    if old_fn is not None:
        turns = [timer.ms(old_fn), timer.ms(kernel), timer.ms(kernel),
                 timer.ms(old_fn)]
        row.update(baseline_turns_ms=turns,     # baseline, new, new, baseline
                   baseline_ms=(turns[0] + turns[3]) / 2,
                   new_in_turns_ms=(turns[1] + turns[2]) / 2)
    log(f"[kernel] flash_attention_bwd[{case}] whole {row['ms'] * 1e3:.1f} us "
        f"(bound {b_ms * 1e3:.2f}, {b_by}); main kernel "
        f"{row['main']['ms'] * 1e3:.1f} us (bound {main_ms * 1e3:.2f}, "
        f"{main_by}; {work['flops'] / row['main']['ms'] * 1e3 / PEAK_BF16:.1%}"
        f" of the bf16 peak); dq conversion {row['convert']['ms'] * 1e3:.1f} "
        f"us (bound {conv_ms * 1e3:.2f}, bytes); delta "
        f"{row['delta_ms'] * 1e3:.1f} us, zeroing {row['zero_ms'] * 1e3:.1f}"
        f" us; SDPA backward {row['library_ms'] * 1e3:.1f} us"
        + (f"; baseline {row['baseline_ms'] * 1e3:.1f} us against "
           f"{row['new_in_turns_ms'] * 1e3:.1f} in turns"
           if old_fn is not None else ""))
    del run, ref_out, qc, kc, vc, out, lse
    return row


def turns_in(row, timer, old_fn, kernel):
    """The earlier kernel in turns with this one (baseline, new, new,
    baseline) into ``row``."""
    turns = [timer.ms(old_fn), timer.ms(kernel), timer.ms(kernel),
             timer.ms(old_fn)]
    row.update(baseline_turns_ms=turns, baseline_ms=(turns[0] + turns[3]) / 2,
               new_in_turns_ms=(turns[1] + turns[2]) / 2)


def baseline_rope(kern, x, sin, cos, sign):
    """A launch of the earlier RoPE kernel (this tree's entry point); its
    launches are not counted."""
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)

    def launch():
        kern.check(kern.fn()(
            x.data_ptr(), sin.data_ptr(), cos.data_ptr(), out.data_ptr(),
            *x.shape, *x.stride()[:3], float(sign),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream))
        return out
    return launch


def measure_rope(cfg, dev, gen, timer, clean, old=None):
    """The standalone RoPE at the ladder's rung-2 shapes: prefill (B 4, S
    256) and training (B 4, S 1024) q and k as the model hands them over,
    strided views of the bf16 q|k GEMM output, and recurrentgemma-2b's
    (phase 16: B 2, S 4096, 10 query heads and one kv head at head_dim
    256); and the backward (the kernel with -sin) at each training q
    shape on a contiguous cotangent, as the flash backward hands it over.
    Plain version: rope_ref (the backward's
    with -sin). Bound: x read once, the output written once and both (S, D)
    tables read once; 6 operations a pair are far below the bytes. Also
    timed from a clean L2 (``clean``); with ``old`` (baseline_kernels), the
    earlier kernel, bit for bit the plain version too, in turns with this
    one."""
    bf16 = torch.bfloat16
    rows = []
    for stage, c, bsz, seq in (
            ("prefill", cfg, BATCH, PROMPT),
            ("train", cfg, TRAIN_BATCH, TRAIN_SEQ),
            ("rg_train", get_config(RG_ARCH), RG_TRAIN_BATCH, RG_TRAIN_SEQ)):
        h, hkv, hd = c.num_heads, c.num_kv_heads, c.head_dim
        qk = torch.randn(bsz, seq, (h + hkv) * hd, generator=gen,
                         device=dev).to(bf16)
        q = qk[..., : h * hd].reshape(bsz, seq, h, hd).transpose(1, 2)
        k = qk[..., h * hd:].reshape(bsz, seq, hkv, hd).transpose(1, 2)
        sin, cos = rope_tables(torch.arange(seq, device=dev), hd,
                               c.rope_theta)
        cases = [(f"{stage}_q", q, 1.0), (f"{stage}_k", k, 1.0)]
        if stage != "prefill":
            cases.append((f"{stage}_q_bwd", torch.randn(
                q.shape, generator=gen, device=dev).to(bf16), -1.0))
        for name, x, sign in cases:
            def kernel(x=x, sign=sign):
                return rope_launch(x, sin, cos, sin_sign=sign)

            def plain(x=x, table=sin if sign > 0 else -sin):
                return rope_ref(x, table, cos)

            got = kernel()
            want = plain()
            torch.cuda.synchronize()
            # one bf16 rounding of the same fp32 value: at most one ulp
            err, tol = check_close(f"rope[{name}]", got, want, 2 ** -7, 0.0)
            b_ms, b_by = bound(nbytes(x, sin, cos, got))
            row = dict(
                case=name, shape=list(x.shape), strides=list(x.stride()),
                max_abs_err=err, tolerance=tol,
                bitwise=bool(torch.equal(got, want)),
                ms=timer.ms(kernel), plain_ms=timer.ms(plain),
                clean_l2_ms=clean.ms(kernel), library_ms=None, bound_ms=b_ms,
                bound_by=b_by)
            if old is not None and old["rope"] is not None:
                old_fn = baseline_rope(old["rope"], x, sin, cos, sign)
                if not torch.equal(old_fn(), got):
                    raise AssertionError(f"baseline rope[{name}] differs "
                                         "from this kernel's bits")
                turns_in(row, timer, old_fn, kernel)
            log(f"[kernel] rope[{name}] {row['ms'] * 1e3:.2f} us, from a "
                f"clean L2 {row['clean_l2_ms'] * 1e3:.2f} (bound "
                f"{b_ms * 1e3:.2f})"
                + (f"; baseline {row['baseline_ms'] * 1e3:.2f} us against "
                   f"{row['new_in_turns_ms'] * 1e3:.2f} in turns"
                   if "baseline_ms" in row else ""))
            rows.append(row)
    return rows


def norm_inputs(dev, gen, rows, dtype):
    """The bench's operands: x and the residual standard normal, weight and
    bias normal (d,) fp32."""
    x = torch.randn(rows, NORM_D, generator=gen, device=dev).to(dtype)
    r = torch.randn(rows, NORM_D, generator=gen, device=dev).to(dtype)
    w = torch.randn(NORM_D, generator=gen, device=dev)
    b = torch.randn(NORM_D, generator=gen, device=dev)
    return x, r, w, b


NORM_CASES = [(rows, torch.float32) for rows in NORM_ROWS] + [
    (NORM_ROWS[-1], torch.bfloat16)]


def check_norm(name, got, want, dtype):
    """new_residual bit for bit (the same fp32 product and sum); normed
    within 1e-5 of its scale in fp32, one bf16 ulp more in bf16 (the row
    sums run in another order)."""
    out, new_res = got
    want_out, want_res = want
    if not torch.equal(new_res, want_res):
        raise AssertionError(f"{name}: new_residual differs from the plain "
                             "version's")
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 0.0
    return check_close(name, out, want_out, rtol, 1e-5)


def baseline_norm(kern, x, r, w, b):
    """A launch of the earlier fused norm kernel (this tree's entry point)
    at the bench's p and seed; its launches are not counted."""
    out, new_res = torch.empty_like(x), torch.empty_like(x)

    def launch():
        kern.check(kern.fn()(
            x.data_ptr(), r.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), new_res.data_ptr(), *x.shape, NORM_SEED, NORM_P,
            1.0 / (1.0 - NORM_P), 1e-5, int(x.dtype == torch.bfloat16),
            int(w.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream))
        return out, new_res
    return launch


def measure_fused_norm(dev, gen, timer, clean, old=None):
    """The fused dropout + residual + layernorm kernel at the memory-bound
    bench's cells. Bound: x, residual, weight and bias read once, both
    outputs written once. No PyTorch call computes the function (no
    library time); a partial yardstick: F.layer_norm of the summed residual
    (precomputed, not timed), which leaves out the dropout, the add and the
    residual output and so moves half the bytes. Also timed from a clean L2
    (``clean``); with ``old`` (baseline_kernels), the earlier kernel, held
    to the plain version, in turns with this one."""
    rows_out = []
    for rows, dtype in NORM_CASES:
        x, r, w, b = norm_inputs(dev, gen, rows, dtype)
        kw = dict(dropout_p=NORM_P)

        def kernel():
            return dropout_residual_layernorm(x, r, w, b, NORM_SEED, **kw)

        def plain():
            return fused_dropout_residual_layernorm_ref(x, r, w, b, NORM_SEED,
                                                        **kw)

        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        name = f"rows{rows}_{str(dtype).split('.')[-1]}"
        err, tol = check_norm(f"fused_norm[{name}]", got, want, dtype)
        b_ms, b_by = bound(nbytes(x, r, w, b, *got))
        summed = r + x
        wl, bl = w.to(dtype), b.to(dtype)
        row = dict(
            case=name, shape=[rows, NORM_D], p=NORM_P, seed=NORM_SEED,
            max_abs_err=err, tolerance=tol, new_residual_bitwise=True,
            ms=timer.ms(kernel), plain_ms=timer.ms(plain),
            clean_l2_ms=clean.ms(kernel), library_ms=None,
            layer_norm_ms=timer.ms(lambda: F.layer_norm(
                summed, (NORM_D,), wl, bl, 1e-5)),
            layer_norm_note="partial yardstick: F.layer_norm of the summed "
            "residual, half the bytes",
            bound_ms=b_ms, bound_by=b_by)
        if old is not None and old["fused_norm"] is not None:
            old_fn = baseline_norm(old["fused_norm"], x, r, w, b)
            got_old = old_fn()
            torch.cuda.synchronize()
            check_norm(f"baseline fused_norm[{name}]", got_old, want, dtype)
            turns_in(row, timer, old_fn, kernel)
        log(f"[kernel] fused_norm[{name}] {row['ms'] * 1e3:.2f} us, from a "
            f"clean L2 {row['clean_l2_ms'] * 1e3:.2f} (bound "
            f"{b_ms * 1e3:.2f}); F.layer_norm alone "
            f"{row['layer_norm_ms'] * 1e3:.2f}"
            + (f"; baseline {row['baseline_ms'] * 1e3:.2f} us against "
               f"{row['new_in_turns_ms'] * 1e3:.2f} in turns"
               if "baseline_ms" in row else ""))
        rows_out.append(row)
        del x, r, summed, got, want
    return rows_out


# ---------------------------------------------------------------------------
# Phase 4: the slice
# ---------------------------------------------------------------------------

def no_launches() -> dict:
    return {k.name: 0 for k in kernels.KERNELS}


def ffn_gemms(cfg) -> int:
    """gemm_fused launches of every layer's FFN, summed by block kind: the
    dense MLP's up and down, or each expert's up and down (an 'moe' block;
    llama4-maverick interleaves the two)."""
    return sum(2 * cfg.moe.num_experts if cfg.layer_kind(i) == "moe" else 2
               for i in range(cfg.num_layers))


def expected_launches(cfg, batches: int, qkv_plan: str = "rope_fused",
                      new_tokens: int = NEW_TOKENS) -> dict:
    """Per layer and served batch: the prefill's fused GEMMs (q|k and v on
    rungs 1 and 2, none on rung 3, whose projections are plain products,
    then the FFN's: ``ffn_gemms``) and one flash prefill, the FFN's fused
    GEMMs and one decode kernel per decode step; on rungs 2 and 3 the RoPE
    kernel for the prefill's q and k (decode rotates its token with the
    plain version)."""
    steps = new_tokens - 1                     # decode calls per batch
    n = batches * cfg.num_layers
    ffn = batches * ffn_gemms(cfg)
    qkv = 0 if qkv_plan == "unfused" else 2 * n
    want = {**no_launches(), "gemm_fused": qkv + ffn * (1 + steps),
            "flash_attention_fwd": n, "flash_decode": n * steps}
    if qkv_plan != "rope_fused":
        want["rope"] = 2 * n
    return want


def teacher_forced_logits(model, params, tokens, prompt: int = PROMPT,
                          new: int = NEW_TOKENS, max_len: int = MAX_LEN):
    """Per-step logits (B, V) fp32 of ``tokens`` (B, prompt + new): prefill
    the prompt into a ``max_len`` cache, then decode the given tokens one by
    one."""
    out = []
    with torch.inference_mode():
        cache = model.init_cache(tokens.shape[0], max_len)
        cache, logits = model.prefill(params, tokens[:, :prompt], cache)
        out.append(logits.float())
        for i in range(new - 1):
            cache, logits = model.decode_step(
                params, tokens[:, prompt + i:prompt + i + 1], cache,
                prompt + i)
            out.append(logits.float())
    return out


@dataclasses.dataclass
class Models:
    """llama-1b at full width with seeded random weights, three ways: the
    kernel path (bf16), the plain path (bf16) and the plain fp32 truth."""
    cfg: object
    kernel: object
    plain: object
    truth: object
    params: dict
    params32: dict


def build_models(dev, arch: str = "llama-1b", layers=None,
                 trained: bool = False, keep_bf16=None) -> Models:
    """``arch`` at its published width with seeded random weights, cut to
    ``layers`` layers where given; with ``trained`` rescaled to a trained
    model's scale (``trained_scale``). ``keep_bf16``: a predicate on a
    leaf's path; the fp32 truth reads those leaves from the bf16 copy
    (upcast where the plain path reaches them, exactly) instead of an fp32
    copy of its own."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    model = build_model(cfg, mode="kernel", device=dev)
    params = model.init(seed=0)
    if trained:
        params = trained_scale(model, params)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    keep = keep_bf16 or (lambda path: False)
    params32 = nest({p: x if keep(p) else x.float()
                     for p, x in named_leaves(params)})
    m = Models(cfg, model, build_model(cfg, mode="reference", device=dev),
               build_model(cfg32, mode="reference", device=dev), params,
               params32)
    torch.cuda.synchronize()
    log(f"[slice] {arch} built: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads (head_dim "
        f"{cfg.head_dim}), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, qkv_bias "
        f"{cfg.qkv_bias}, rope {cfg.rope_style} (theta {cfg.rope_theta:g}), "
        f"tied {cfg.tie_embeddings}; init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    return m


def check_graph_replay(tag, entry, cache, inputs, eager) -> None:
    """A decode bucket's captured graph, replayed on ``inputs`` from the
    cache state it finds, against the eager step ``eager(cache)`` from a
    copy of that state: the logits, the cache afterwards (every tensor of
    a nested cache: an encoder-decoder's self and cross parts) and the
    launch counts equal, bit for bit and exactly."""
    if entry.graph is None:
        raise AssertionError(f"[{tag}] the decode bucket holds no graph")
    # the engines' buffers are inference tensors, written in that mode
    with torch.inference_mode():
        saved = tree_map(torch.clone, cache)
        kernels.reset_launch_counts()
        replayed = entry(**inputs).clone()
        torch.cuda.synchronize()
        replay_counts = kernels.launch_counts()
        after = tree_map(torch.clone, cache)
        kernels.reset_launch_counts()
        want = eager(saved)
        torch.cuda.synchronize()
        eager_counts = kernels.launch_counts()
    pairs = zip(named_leaves(after), named_leaves(saved))
    if replay_counts != eager_counts or not torch.equal(replayed, want) \
            or not all(torch.equal(x, y) for (_, x), (_, y) in pairs):
        raise AssertionError(
            f"[{tag}] a replayed decode step differs from the eager step: "
            f"logits max diff {(replayed - want).abs().max().item():.4g}, "
            f"launches {replay_counts} vs {eager_counts}")
    log(f"[{tag}] a replayed decode step equals the eager step bit for bit "
        f"(logits and cache), launches {replay_counts}")


@contextlib.contextmanager
def routed(record=None, replay=None, flips=None):
    """Expert routing shared across the teacher-forced runs of one check
    (``moe._route`` patched while the block runs; a dense model makes no
    call): with ``record`` each call's ids are appended to it; with
    ``replay`` each call routes to the next recorded ids instead of its own
    top k, weighted by its own probabilities there (renormalised), and
    appends to ``flips`` how many of its tokens its own router sent to
    another expert set. A routing flip at a near tie is discrete: a token
    served by other experts is no measure of the arithmetic's error, so the
    plain paths are held to the kernel path on its routing."""
    orig = moe_mod._route
    calls = iter(replay or ())

    def route(cfg, x, w):
        weights, ids, aux = orig(cfg, x, w)
        if record is not None:
            record.append(ids)
        if replay is not None:
            forced = next(calls)
            if flips is not None:
                flips.append(int((forced.sort(-1).values
                                  != ids.sort(-1).values).any(-1).sum()))
            probs = torch.softmax(x.float() @ w.float(), dim=-1).gather(
                1, forced)
            weights = (probs / torch.clamp(probs.sum(-1, keepdim=True),
                                           min=1e-9)).to(x.dtype)
            ids = forced
        return weights, ids, aux

    moe_mod._route = route
    try:
        yield
    finally:
        moe_mod._route = orig
    if next(calls, None) is not None:
        raise AssertionError("a replayed run routed fewer times than the "
                             "recorded one")


def check_routing(tag, route, flips):
    """The share of the kernel path's token-layer expert choices that the
    fp32 router (``flips``, from ``routed``) would have made otherwise,
    under MAX_REROUTED; None for a dense model."""
    if not route:
        return None
    choices = sum(r.shape[0] for r in route)
    share = sum(flips) / choices
    log(f"[{tag}] routing: along the kernel path, the fp32 router picks "
        f"another expert set for {sum(flips)} of {choices} token-layer "
        f"choices ({share:.4f}); the plain paths follow the kernel path's")
    if share > MAX_REROUTED:
        raise AssertionError(f"[{tag}] the fp32 router disagrees with the "
                             f"kernel path on {share:.4f} of the choices")
    return {"choices": choices, "rerouted": sum(flips), "share": share}


def teacher_forced_routed(m, model, params, tokens, *args):
    """(kernel-path, plain bf16, fp32 truth) teacher-forced logits of
    ``tokens`` (``teacher_forced_logits(..., *args)``), the plain paths
    routed as the kernel path (``routed``), and the routing summary."""
    route, flips = [], []
    with routed(record=route):
        kern = teacher_forced_logits(model, params, tokens, *args)
    with routed(replay=route):
        plain = teacher_forced_logits(m.plain, params, tokens, *args)
    with routed(replay=route, flips=flips):
        truth = teacher_forced_logits(m.truth, m.params32, tokens, *args)
    return kern, plain, truth, (route, flips)


def check_logit_bound(name, kern, plain, truth):
    """Each step's kernel-path logits no further from fp32 than 2x the plain
    bf16 path's distance + 1e-2; returns the largest share of the bound
    used and the greedy agreement with the plain path."""
    worst = 0.0
    agree = 0
    for i, (k, p, t) in enumerate(zip(kern, plain, truth)):
        k_err = (k - t).abs().max().item()
        p_err = (p - t).abs().max().item()
        if not k_err <= 2.0 * p_err + 1e-2:
            raise AssertionError(f"{name} step {i}: kernel path logits are "
                                 f"{k_err:.4g} from fp32, plain bf16 path "
                                 f"{p_err:.4g}")
        worst = max(worst, k_err / (2.0 * p_err + 1e-2))
        agree += int((k.argmax(-1) == p.argmax(-1)).sum())
    return worst, agree / sum(k.numel() // k.shape[-1] for k in kern)


def check_eager_decode(tag, entry, before: int, want: int) -> None:
    """A decode bucket of a model built over a mesh runs eagerly (its MoE
    blocks run NCCL collectives, which the engines do not capture): it
    holds no graph and counted ``want`` eager steps since ``before``."""
    got = entry.eager_steps - before
    if entry.graph is not None or not entry.eager or got != want:
        raise AssertionError(f"[{tag}] decode bucket eager {entry.eager}, "
                             f"graph {entry.graph is not None}, {got} eager "
                             f"steps counted, {want} run")
    log(f"[{tag}] the decode steps ran eagerly, as a model over a mesh "
        f"does: {got} eager steps counted (engine.decode_eager), no graph")


def run_slice(dev, m: Models, model=None, tag: str = "slice",
              serve_ctx=contextlib.nullcontext):
    """Phase 4 (``m.kernel``) or 7a (``model``, another rung of the QKV
    ladder): serve, check the launches and the served streams, then hold the
    teacher-forced logits of the first batch to the fp32 truth. A model
    built over a mesh decodes eagerly (``check_eager_decode``) where the
    others replay their decode steps from a graph; ``serve_ctx`` wraps the
    served requests (not the warm-up or the teacher forcing)."""
    cfg, params = m.cfg, m.params
    model = model or m.kernel
    engine = Engine(model, params, max_len=MAX_LEN)
    rng = np.random.default_rng(0)
    # one warm-up batch of the served shape (cuBLAS handles, allocator)
    engine.generate(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)), 2)
    engine.timings.clear()

    queue = RequestQueue(engine, batch_size=BATCH, buckets=(PROMPT,))
    reqs = [Request(uid, rng.integers(0, cfg.vocab_size,
                                      int(rng.integers(128, PROMPT + 1)))
                    .astype(np.int32), NEW_TOKENS)
            for uid in range(REQUESTS)]
    for r in reqs:
        queue.submit(r)
    entry = engine._buckets[("decode", BATCH)]
    before = entry.eager_steps
    kernels.reset_launch_counts()
    with serve_ctx():
        served = queue.flush(force=True)
    counts = kernels.launch_counts()
    log(f"[{tag}] served {served} requests; launches {counts}; "
        f"bucket_lru {engine.lru_stats}")
    want = expected_launches(cfg, REQUESTS // BATCH, model.qkv_plan)
    if served != REQUESTS or counts != want:
        raise AssertionError(f"served {served}, launches {counts}; the main "
                             f"path makes {want}")
    if entry.eager:
        check_eager_decode(tag, entry, before,
                           REQUESTS // BATCH * (NEW_TOKENS - 1))
    else:
        token = torch.arange(BATCH, device=dev)[:, None] * 7 + 1

        def eager(cache):
            return model.decode_step(params, token, cache, PROMPT + 3)[1]
        check_graph_replay(tag, entry, entry.cache,
                           dict(token=token, pos=PROMPT + 3), eager)
    for r in reqs:
        check_result(cfg, r, queue.results[r.uid])
    pre_tok = sum(t["batch"] * t["prompt_len"] for t in engine.timings)
    pre_s = sum(t["prefill_s"] for t in engine.timings)
    dec_tok = sum(t["batch"] * (t["new_tokens"] - 1) for t in engine.timings)
    dec_s = sum(t["decode_s"] for t in engine.timings)
    throughput = {"prefill_tokens_per_s": pre_tok / pre_s,
                  "decode_tokens_per_s": dec_tok / dec_s,
                  "prefill_s": pre_s, "decode_s": dec_s}
    log(f"[{tag}] prefill {pre_tok} tokens in {pre_s:.4f} s "
        f"({throughput['prefill_tokens_per_s']:.1f} tok/s); decode "
        f"{dec_tok} tokens in {dec_s:.4f} s "
        f"({throughput['decode_tokens_per_s']:.1f} tok/s)")

    # teacher forcing on the first served batch
    first = reqs[:BATCH]
    tokens = torch.tensor(np.stack([
        np.pad(queue.results[r.uid], (PROMPT - len(r.prompt), 0))
        for r in first]), dtype=torch.int64, device=dev)
    kern, plain, truth, routes = teacher_forced_routed(m, model, params,
                                                       tokens)
    greedy = torch.stack([lg.argmax(-1) for lg in kern], dim=1)
    if not torch.equal(greedy, tokens[:, PROMPT:]):
        raise AssertionError("the served greedy tokens differ from the "
                             "argmax of the kernel path's teacher-forced "
                             "logits")
    routing = check_routing(tag, *routes)
    worst, agreement = check_logit_bound(tag, kern, plain, truth)
    log(f"[{tag}] teacher-forced logits over {len(kern)} steps: kernel-path "
        f"error vs fp32 at most {worst:.3f} of its bound (2 x plain bf16 "
        f"error + 1e-2); greedy agreement with the plain bf16 path "
        f"{agreement:.3f} (information only)")
    return {"served": served, "launches": counts, "throughput": throughput,
            "bucket_lru": dict(engine.lru_stats),
            "logit_bound_use": worst, "greedy_agreement": agreement,
            "routing": routing, "teacher_forced": (tokens, plain, truth)}


def check_result(cfg, req, row):
    if row.shape != (len(req.prompt) + req.max_new_tokens,) or \
            not ((row >= 0) & (row < cfg.vocab_size)).all() or \
            not np.array_equal(row[: len(req.prompt)], req.prompt):
        raise AssertionError(f"request {req.uid}: bad result {row}")


# ---------------------------------------------------------------------------
# Phase 5: the paged slice
# ---------------------------------------------------------------------------

PHASES = {
    # pool pressure: 32 usable pages for 8 slots of up to 6 pages each
    "5a": dict(n_pages=33),
    "5b": dict(prefix_cache=True, chunk_tokens=CHUNK),
}
# phase 8b: the dense decoders' paged traffic, chunked prefill
DENSE_PAGED = dict(chunk_tokens=CHUNK)


def paged_requests(cfg, phase: str) -> list:
    """5a: 16 requests, prompts of 96-320 tokens, 16-64 new tokens. 5b: 12
    requests sharing a 192-token (3-page) prefix plus 32-160 tokens of
    their own, 16-64 new tokens. 8b: phase 4's traffic, 8 requests of
    128-256 tokens and 32 new ones. Seeded, greedy."""
    v = cfg.vocab_size
    if phase == "8b":
        rng = np.random.default_rng(0)
        return [Request(u, rng.integers(0, v, int(rng.integers(128, PROMPT + 1)))
                        .astype(np.int32), NEW_TOKENS) for u in range(REQUESTS)]
    if phase == "5a":
        rng = np.random.default_rng(0)
        return [Request(u, rng.integers(0, v, int(rng.integers(96, 321)))
                        .astype(np.int32), int(rng.integers(16, 65)))
                for u in range(16)]
    rng = np.random.default_rng(1)
    head = rng.integers(0, v, 3 * PAGE).astype(np.int32)
    return [Request(u, np.concatenate(
        [head, rng.integers(0, v, int(rng.integers(32, 161)))
         .astype(np.int32)]), int(rng.integers(16, 65))) for u in range(12)]


def expected_paged_launches(cfg, engine) -> dict:
    """What the engine's own counters imply: per layer, a prefill or chunk
    runs q|k and v and the FFN's fused GEMMs (``ffn_gemms``: the SwiGLU up
    and down, or an MoE's per expert) and a decode step the FFN's; flash
    prefill per exact-length prefill, the paged kernel per decode step and
    per chunk."""
    n, ffn = cfg.num_layers, ffn_gemms(cfg)
    pre, chunks, steps = (engine.prefills, engine.chunks_prefilled,
                          engine.decode_steps)
    return {**no_launches(),
            "gemm_fused": (2 * n + ffn) * (pre + chunks) + ffn * steps,
            "flash_attention_fwd": n * pre,
            "flash_decode_paged": n * (steps + chunks)}


def paged_replay(engine, model, params, row, plen: int, chunk, dev,
                 block: int = 1, slots: int = SLOTS,
                 max_pages: int = MAX_PAGES):
    """Teacher-forced logits (fp32, one (V,) row per served token) of one
    served stream in a lone slot of a ``slots``-row table of ``max_pages``
    pages a row: the engine's route
    (exact-length prefill, or ``chunk``-token chunks), then the served
    tokens in steps of ``block`` over the table sliced to the page bucket
    ``engine`` gives that slot alone: decode steps (1), or verify steps
    (SPEC_TOKENS: row t of the step at ``base`` predicts position base +
    t + 1, as a speculative round that accepts everything)."""
    row64 = np.concatenate([np.asarray(row, np.int64),
                            np.zeros(block - 1, np.int64)])
    n_pages = kvc.num_pages_needed(len(row64), PAGE)
    cache = model.init_paged_cache(slots, n_pages + 1, PAGE)
    state = kvc.init_page_state(slots, max_pages)
    kvc.assign_slot(state, 0, list(range(1, n_pages + 1)), plen)
    out = []
    with torch.inference_mode():
        if chunk is None:
            cache, logits = model.prefill_paged(
                params, torch.as_tensor(row64[None, :plen], device=dev),
                cache, state["page_table"][0], 0, plen)
        else:
            for start in range(0, plen, chunk):
                end = min(plen, start + chunk)
                toks = np.zeros((1, chunk), np.int64)
                toks[0, : end - start] = row64[start:end]
                cache, logits = model.prefill_paged_chunk(
                    params, torch.as_tensor(toks, device=dev), cache,
                    state["page_table"][0], start,
                    plen - 1 - start if end == plen else 0)
        out.append(logits[0].float())
        for base in range(plen, len(row) - 1, block):
            # the slot holds the pages of the step's last token (grown just
            # in time before the step)
            bucket = engine.page_bucket(kvc.num_pages_needed(base + block,
                                                             PAGE))
            tokens = np.zeros((slots, block), np.int64)
            tokens[0] = row64[base:base + block]
            lengths = np.zeros((slots,), np.int32)
            lengths[0] = base
            cache, logits = model.decode_step_paged(
                params, torch.as_tensor(tokens, device=dev), cache,
                state["page_table"][:, :bucket], lengths)
            out += ([logits[0].float()] if block == 1 else
                    [logits[0, t].float() for t in range(block)])
    return out[: len(row) - plen]


def run_paged_phase(dev, m: Models, phase: str, tag=None) -> dict:
    cfg = m.cfg
    tag = tag or phase
    kw = dict(batch_slots=SLOTS, page_size=PAGE, max_pages_per_seq=MAX_PAGES,
              **(DENSE_PAGED if phase == "8b" else PHASES[phase]))
    chunk = kw.get("chunk_tokens")
    # warm-up of the same route (cuBLAS plans at the decode shapes)
    warm = PagedEngine(m.kernel, m.params, **kw)
    for u in range(2):
        warm.submit(Request(u, np.arange(1, 100 + u, dtype=np.int32), 3))
    warm.run()
    del warm          # and its decode graphs' memory

    engine = PagedEngine(m.kernel, m.params, **kw)
    reqs = paged_requests(cfg, phase)
    for r in reqs:
        engine.submit(r)
    kernels.reset_launch_counts()
    results = engine.run()
    counts = kernels.launch_counts()
    rep = engine.report()
    want = expected_paged_launches(cfg, engine)
    log(f"[{tag}] served {len(results)} requests in {rep['steps']} steps: "
        f"{rep['prefills']} exact prefills, {engine.chunks_prefilled} chunks, "
        f"{rep['decode_steps']} decode steps, {rep['preemptions']} "
        f"preemptions, peak {rep['peak_pages_in_use']} of "
        f"{rep['page_pool_size']} pages; launches {counts}; bucket_lru "
        f"{rep['bucket_lru']}")
    if counts != want:
        raise AssertionError(f"[{tag}] launches {counts}; the engine's "
                             f"counters imply {want}")
    path = ("gemm_fused", "flash_decode_paged") + (
        ("flash_attention_fwd",) if phase == "5a" else ())
    if not all(counts[k] > 0 for k in path):
        raise AssertionError(f"[{tag}] a kernel of the path never ran")
    if sorted(results) != [r.uid for r in reqs]:
        raise AssertionError(f"[{tag}] completed {sorted(results)}")
    for r in reqs:
        check_result(cfg, r, results[r.uid])
    held = rep.get("prefix_cache", {}).get("pages_held", 0)
    if engine.alloc.free_pages != engine.n_pages - 1 - held:
        raise AssertionError(f"[{tag}] {engine.alloc.free_pages} pages "
                             f"free, {held} held by the trie, of "
                             f"{engine.n_pages - 1}")
    # the first decode bucket still cached, on a lone slot over its pages
    key = next(k for k in engine._buckets if isinstance(k[0], int))
    mp = key[1]
    token = torch.zeros((SLOTS, 1), dtype=torch.int64, device=dev)
    token[0, 0] = 11
    table = torch.zeros((SLOTS, mp), dtype=torch.int32, device=dev)
    table[0] = torch.arange(1, mp + 1, dtype=torch.int32)
    lengths = torch.zeros((SLOTS,), dtype=torch.int32, device=dev)
    lengths[0] = mp * PAGE - 5

    def eager(pools):
        return m.kernel.decode_step_paged(m.params, token, pools, table,
                                          lengths)[1]
    check_graph_replay(f"{tag} bucket {key}", engine._buckets[key],
                       engine.cache, dict(token=token, page_table=table,
                                          lengths=lengths), eager)
    if phase == "5a" and rep["preemptions"] < 1:
        raise AssertionError("[5a] the pool never forced a preemption")
    if phase == "5b":
        if rep["prefix_cache"]["hits"] < 1 or engine.chunks_prefilled < 1:
            raise AssertionError(f"[5b] prefix hits "
                                 f"{rep['prefix_cache']['hits']}, chunks "
                                 f"{engine.chunks_prefilled}")
        log(f"[5b] prefix cache {rep['prefix_cache']}")
    t = rep["timings"]
    throughput = {"prefill_tokens_per_s": t["prefill_tokens"] / t["prefill_s"],
                  "decode_tokens_per_s": t["decode_tokens"] / t["decode_s"],
                  **t}
    log(f"[{tag}] prefill {t['prefill_tokens']} tokens in "
        f"{t['prefill_s']:.4f} s ({throughput['prefill_tokens_per_s']:.1f} "
        f"tok/s); decode {t['decode_tokens']} tokens in {t['decode_s']:.4f} s "
        f"({throughput['decode_tokens_per_s']:.1f} tok/s)")

    # preempted or prefix-matched streams take another route: not replayed
    other_route = set(rep["preempted_uids"]) | set(
        rep.get("prefix_cache", {}).get("hit_uids", ()))
    replayed = [r for r in reqs if r.uid not in other_route][:2]
    if len(replayed) < 2:
        raise AssertionError(f"[{tag}] fewer than two requests kept the "
                             "plain route")
    kern, plain, truth, route, flips = [], [], [], [], []
    for r in replayed:
        row, plen = results[r.uid], len(r.prompt)
        mine = []
        with routed(record=mine):
            k = paged_replay(engine, m.kernel, m.params, row, plen, chunk,
                             dev)
        greedy = np.array([int(x.argmax()) for x in k])
        if not np.array_equal(greedy, row[plen:]):
            raise AssertionError(f"[{tag}] request {r.uid}: the lone-slot "
                                 "replay's greedy tokens differ from the "
                                 "served ones")
        kern += k
        route += mine
        with routed(replay=mine):
            plain += paged_replay(engine, m.plain, m.params, row, plen, chunk,
                                  dev)
        with routed(replay=mine, flips=flips):
            truth += paged_replay(engine, m.truth, m.params32, row, plen,
                                  chunk, dev)
    routing = check_routing(tag, route, flips)
    worst, agreement = check_logit_bound(tag, kern, plain, truth)
    log(f"[{tag}] replayed requests {[r.uid for r in replayed]} in a lone "
        f"slot: greedy tokens equal the served ones over {len(kern)} steps; "
        f"kernel-path error vs fp32 at most {worst:.3f} of its bound; "
        f"greedy agreement with the plain bf16 path {agreement:.3f} "
        f"(information only)")
    return {"report": rep, "launches": counts, "throughput": throughput,
            "replayed": [r.uid for r in replayed], "routing": routing,
            "logit_bound_use": worst, "greedy_agreement": agreement}


# ---------------------------------------------------------------------------
# Phase 6: training
# ---------------------------------------------------------------------------

def expected_train_launches(cfg, steps: int) -> dict:
    """Per layer and step under remat_policy='full': the forward's 4 fused
    GEMMs and flash forward, again in the backward's recompute, then for
    each GEMM its backward's operand pass, dA and dB (4 each), and the
    flash backward's two launches (the main kernel and the dq
    conversion)."""
    n = cfg.num_layers * steps
    return {**no_launches(), "gemm_fused": 8 * n, "flash_attention_fwd": 2 * n,
            "gemm_bwd_g": 4 * n, "gemm_bwd_da": 4 * n, "gemm_bwd_db": 4 * n,
            "flash_attention_bwd": 2 * n}


def train_data(cfg, dev, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ):
    """The LM pipeline's batches of ``seq`` tokens; for the vlm family its
    ``seq - num_patches`` text tokens behind seeded random patch embeddings
    (bf16, as ``make_batch`` draws them): text with structure, so a few
    steps' loss can fall, where ``make_batch``'s uniform tokens stay at
    log V."""
    if cfg.family != "vlm":
        return DataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=seq, global_batch=batch),
                            device=dev)
    return vlm_batches(cfg, dev, batch, seq)


def vlm_batches(cfg, dev, batch: int, seq: int):
    text = DataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=seq - cfg.num_patches,
                                   global_batch=batch), device=dev)
    gen = torch.Generator(device=dev).manual_seed(19)
    while True:
        patches = torch.randn((batch, cfg.num_patches, cfg.d_model),
                              generator=gen, device=dev)
        yield dict(next(text), patch_embeds=patches.to(torch.bfloat16))


def trained_scale(model, params) -> dict:
    """The seeded weights rescaled to std fan_in^-1/2 over each matrix's
    input dim (the tied embedding's over d_model, an SSD block's conv
    filter's over its taps), the matrices in place. The reference's init draws a stacked matrix
    at std (layers)^-1/2: 0.71 at 2 layers, where the bf16 grads of every
    path are rounding noise as large as the grads themselves. An SSD
    block's decay rates and time steps are drawn as Mamba2's published
    init draws them, per layer and head from a seed: A = exp(a_log)
    uniform in [1, 16], dt = softplus(dt_bias) log-uniform in [0.001, 0.1]
    (the reference's init gives every head A = e and dt = log 2, a state
    that forgets in a few tokens)."""
    out = {}
    for path, x in named_leaves(params):
        d = model.defs[path]
        if d.init == "normal" and len(d.shape) > 1:
            fan = (d.shape[-1] if path == "embed"
                   or path.endswith("ssm/conv_w") else d.shape[-2])
            x = x.mul_((d.shape[0] / fan) ** 0.5)
        elif path.endswith(("ssm/a_log", "ssm/dt_bias")):
            gen = torch.Generator(device=x.device).manual_seed(
                int(path.endswith("dt_bias")))
            u = torch.rand(x.shape, generator=gen, device=x.device)
            if path.endswith("a_log"):
                x = torch.log(1 + 15 * u).to(x.dtype)
            else:
                dt = torch.exp(np.log(1e-3) + u * np.log(100.0))
                x = (dt + torch.log(-torch.expm1(-dt))).to(x.dtype)
        out[path] = x
    return nest(out)


def run_grad_check(dev) -> dict:
    """Phase 6a: per-leaf grads of lm_loss at llama-1b widths, 2 layers."""
    cfg = dataclasses.replace(get_config("llama-1b"), num_layers=2)
    batch = next(train_data(cfg, dev))

    def grads(mode, dtype):
        model = build_model(dataclasses.replace(cfg, compute_dtype=dtype),
                            mode=mode, device=dev)
        params = tree_map(lambda t: t.requires_grad_(), trained_scale(
            model, model.init(seed=0, dtype=cfg.param_dtype)))
        kernels.reset_launch_counts()
        loss, _, g = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        named = {path: x.float() for (path, _), x
                 in zip(named_leaves(params), g)}
        return float(loss), named, kernels.launch_counts()

    k_loss, kern, counts = grads("kernel", "bfloat16")
    want = expected_train_launches(cfg, 1)
    if counts != want:
        raise AssertionError(f"[6a] launches {counts}; one step of "
                             f"{cfg.num_layers} layers makes {want}")
    p_loss, plain, _ = grads("reference", "bfloat16")
    t_loss, truth, _ = grads("reference", "float32")
    worst, per_leaf = 0.0, {}
    for path, t_ in truth.items():
        k_, p_ = kern[path], plain[path]
        k_err = (k_ - t_).abs().max().item()
        p_err = (p_ - t_).abs().max().item()
        per_leaf[path] = {"kernel_err": k_err, "plain_err": p_err,
                          "truth_max": t_.abs().max().item()}
        if not k_err <= 2.0 * p_err + 1e-3:
            raise AssertionError(f"[6a] {path}: kernel-mode grad {k_err:.4g} "
                                 f"from fp32, plain bf16 {p_err:.4g}")
        worst = max(worst, k_err / (2.0 * p_err + 1e-3))
    log(f"[6a] llama-1b widths, {cfg.num_layers} layers, weights at std "
        f"fan_in^-1/2, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens: loss kernel {k_loss:.5f}, plain bf16 "
        f"{p_loss:.5f}, fp32 {t_loss:.5f}; every one of {len(truth)} leaves' "
        f"kernel-mode grad error within its bound (2 x plain bf16 error + "
        f"1e-3), at most {worst:.3f} of it")
    return {"losses": {"kernel": k_loss, "plain": p_loss, "truth": t_loss},
            "launches": counts, "bound_use": worst, "leaves": per_leaf}


def train_curve(cfg, mode, dtype, dev, steps: int = TRAIN_STEPS,
                qkv_plan: str = "rope_fused", trained: bool = False,
                batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                **loop_kw) -> dict:
    """``steps`` steps of train_loop from seed 0 on the ported data
    (``batch`` x ``seq`` tokens a step), on the schedule of a
    TRAIN_STEPS-step run; with ``trained`` from the seeded weights at a
    trained model's scale (``trained_scale``); ``loop_kw`` to
    train_loop."""
    model = build_model(dataclasses.replace(cfg, compute_dtype=dtype),
                        mode=mode, device=dev, qkv_plan=qkv_plan)
    if trained:
        loop_kw["params"] = trained_scale(
            model, model.init(seed=0, dtype=cfg.param_dtype))
    opt = AdamWConfig(schedule=cosine_schedule(TRAIN_LR, 2, TRAIN_STEPS))
    data = train_data(cfg, dev, batch, seq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = train_loop(model, data, steps, opt, seed=0, log_every=0, **loop_kw)
    counts = kernels.launch_counts()
    out = {"losses": res.losses, "step_seconds": res.step_seconds,
           "launches": counts,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "ef_bytes": sum(e.numel() * e.element_size()
                           for e in leaves(res.state.get("ef", {})))}
    del res
    torch.cuda.empty_cache()
    return out


def run_training(dev) -> dict:
    """Phase 6b: all 16 layers of llama-1b, kernel mode, through
    train_loop; then the plain bf16 and fp32 curves of the same steps."""
    cfg = get_config("llama-1b")
    kern = train_curve(cfg, "kernel", "bfloat16", dev)
    want = expected_train_launches(cfg, TRAIN_STEPS)
    losses = kern["losses"]
    step_s = statistics.median(kern["step_seconds"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[6b] llama-1b, {cfg.num_layers} layers, remat "
        f"{cfg.remat_policy!r}, {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens in kernel mode: losses "
        f"{[round(x, 4) for x in losses]}; launches {kern['launches']}")
    if kern["launches"] != want:
        raise AssertionError(f"[6b] launches {kern['launches']}; "
                             f"{TRAIN_STEPS} steps of the model make {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[6b] losses {losses}: not finite and falling")
    log(f"[6b] step time {step_s:.4f} s (median of the steps after the "
        f"first), {tokens / step_s:.1f} tokens/s; peak device memory "
        f"{kern['peak_memory_gb']:.2f} GB")
    plain = train_curve(cfg, "reference", "bfloat16", dev)
    truth = train_curve(cfg, "reference", "float32", dev)
    k_err = float(np.abs(np.subtract(losses, truth["losses"])).max())
    p_err = float(np.abs(np.subtract(plain["losses"], truth["losses"])).max())
    log(f"[6b] plain bf16 losses {[round(x, 4) for x in plain['losses']]}; "
        f"fp32 {[round(x, 4) for x in truth['losses']]}; the kernel curve is "
        f"{k_err:.4g} from fp32, the plain bf16 curve {p_err:.4g} (bound "
        f"2.5 x {p_err:.4g} + 0.05)")
    if not k_err <= 2.5 * p_err + 0.05:
        raise AssertionError(f"[6b] kernel curve {k_err:.4g} from the fp32 "
                             f"truth, plain bf16 {p_err:.4g}")
    prof = profile_step(build_model(cfg, mode="kernel", device=dev),
                        TRAIN_BATCH, TRAIN_SEQ, warmup=1)
    tr = prof["traced"]
    log(f"[6b] one traced step: device busy {tr['device_busy_ms']:.1f} of "
        f"{tr['traced_wall_ms']:.1f} ms ({tr['device_busy_share']:.3f}); "
        f"device ms by family "
        f"{ {k: round(v, 2) for k, v in tr['device_ms_by_family'].items()} }")
    return {"launches": kern["launches"], "kernel": kern, "plain": plain,
            "truth": truth, "curve_err": {"kernel": k_err, "plain": p_err},
            "step_s": step_s, "tokens_per_s": tokens / step_s,
            "profile": prof}


# ---------------------------------------------------------------------------
# Phase 7: the ladder's standalone-RoPE rungs and the fused norm op
# ---------------------------------------------------------------------------

def run_ladder_serve(dev, m: Models) -> dict:
    """7a: phase 4's traffic on rung 2 (``qkv_plan="norm_fused"``); 7c: one
    teacher-forced pass of 7a's first batch on rung 3 (``"unfused"``), held
    to the fp32 truth under 7a's bound."""
    rung2 = build_model(m.cfg, mode="kernel", device=dev,
                        qkv_plan="norm_fused")
    out = {"7a": run_slice(dev, m, rung2, tag="7a")}
    tokens, plain, truth = out["7a"].pop("teacher_forced")
    rung3 = build_model(m.cfg, mode="kernel", device=dev, qkv_plan="unfused")
    kernels.reset_launch_counts()
    kern = teacher_forced_logits(rung3, m.params, tokens)
    counts = kernels.launch_counts()
    want = expected_launches(m.cfg, 1, "unfused")
    if counts != want:
        raise AssertionError(f"[7c] launches {counts}; one teacher-forced "
                             f"batch on rung 3 makes {want}")
    worst, agreement = check_logit_bound("7c", kern, plain, truth)
    log(f"[7c] qkv_plan 'unfused', teacher-forced logits over {len(kern)} "
        f"steps: error vs fp32 at most {worst:.3f} of its bound (2 x plain "
        f"bf16 error + 1e-2); launches {counts}")
    out["7c"] = {"launches": counts, "logit_bound_use": worst,
                 "greedy_agreement": agreement}
    return out


def run_ladder_train(dev, curves: dict) -> dict:
    """7b: the first LADDER_STEPS steps of 6b's run (same data, seed and
    schedule) on rung 2, held to 6b's fp32 curve over those steps under
    6b's bound, against the plain bf16 curve's distance."""
    cfg = get_config("llama-1b")
    run = train_curve(cfg, "kernel", "bfloat16", dev, steps=LADDER_STEPS,
                      qkv_plan="norm_fused")
    n = cfg.num_layers * LADDER_STEPS
    want = {**expected_train_launches(cfg, LADDER_STEPS), "rope": 6 * n}
    losses = run["losses"]
    log(f"[7b] qkv_plan 'norm_fused', {LADDER_STEPS} steps: losses "
        f"{[round(x, 4) for x in losses]}; launches {run['launches']}")
    if run["launches"] != want:
        raise AssertionError(f"[7b] launches {run['launches']}; "
                             f"{LADDER_STEPS} steps on rung 2 make {want}")
    truth = curves["truth"]["losses"][:LADDER_STEPS]
    plain = curves["plain"]["losses"][:LADDER_STEPS]
    k_err = float(np.abs(np.subtract(losses, truth)).max())
    p_err = float(np.abs(np.subtract(plain, truth)).max())
    log(f"[7b] the rung-2 curve is {k_err:.4g} from 6b's fp32 curve over "
        f"these steps, the plain bf16 curve {p_err:.4g} (bound 2.5 x "
        f"{p_err:.4g} + 0.05); step time "
        f"{statistics.median(run['step_seconds'][1:]):.4f} s")
    if not all(np.isfinite(losses)) or not k_err <= 2.5 * p_err + 0.05:
        raise AssertionError(f"[7b] losses {losses}: {k_err:.4g} from the "
                             f"fp32 truth, plain bf16 {p_err:.4g}")
    return {**run, "curve_err": {"kernel": k_err, "plain": p_err}}


def run_norm_op(dev) -> dict:
    """7d: dropout_residual_layernorm through the public op at the bench's
    cells: the outputs against the plain version, and the kernel's
    keep-mask bit for bit the plain one's, read from a probe call with
    x = 1 and residual = 0 (new_residual is the scale where a lane is kept,
    0 where it is dropped)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    kernels.reset_launch_counts()
    calls, cases = 0, []
    for rows, dtype in NORM_CASES:
        x, r, w, b = norm_inputs(dev, gen, rows, dtype)
        got = dropout_residual_layernorm(x, r, w, b, NORM_SEED,
                                         dropout_p=NORM_P)
        ones = torch.ones_like(x)
        _, probe = dropout_residual_layernorm(ones, torch.zeros_like(x), w, b,
                                              NORM_SEED, dropout_p=NORM_P)
        calls += 2
        torch.cuda.synchronize()
        name = f"rows{rows}_{str(dtype).split('.')[-1]}"
        err, _ = check_norm(f"[7d] {name}", got, fused_dropout_residual_layernorm_ref(
            x, r, w, b, NORM_SEED, dropout_p=NORM_P), dtype)
        keep = dropout_keep_mask_ref(NORM_SEED, x.shape, NORM_P, dev)
        if not torch.equal(probe != 0, keep):
            raise AssertionError(f"[7d] {name}: the kernel's keep-mask "
                                 "differs from the plain version's")
        cases.append({"case": name, "max_abs_err": err,
                      "kept_share": keep.float().mean().item()})
        del x, r, got, ones, probe, keep
    counts = kernels.launch_counts()
    if counts != {**no_launches(), "fused_norm": calls}:
        raise AssertionError(f"[7d] launches {counts}; {calls} calls made")
    log(f"[7d] dropout_residual_layernorm at {len(cases)} bench cells: "
        f"outputs within tolerance, keep-masks bit for bit the plain ones "
        f"{[(c['case'], round(c['kept_share'], 4)) for c in cases]}; "
        f"launches {counts}")
    return {"launches": counts, "cases": cases}


# ---------------------------------------------------------------------------
# Phase 8: the dense decoders of the registry at published width
# ---------------------------------------------------------------------------

def run_dense(dev) -> dict:
    """8a: phase 4's traffic through RequestQueue(Engine) and 8b: the same
    number of requests through PagedEngine with 128-token chunks, for each
    config of DENSE in turn (freed before the next), with phases 4's and
    5's checks. The weights are at a trained model's scale, as in 6a: at
    the reference's init (std (layers)^-1/2, 0.5 at 4 layers) attention is
    near one-hot and a bf16 rounding of a key flips which key wins, so
    every bf16 path's logits lie a large share of their scale from fp32
    and the kernel path and the plain path are two draws of that noise."""
    out = {}
    for arch, layers in DENSE:
        m = build_models(dev, arch, layers, trained=True)
        a = run_slice(dev, m, tag=f"8a {arch}")
        del a["teacher_forced"]
        b = run_paged_phase(dev, m, "8b", tag=f"8b {arch}")
        out[f"8a {arch}"], out[f"8b {arch}"] = a, b
        log(f"[8 {arch}] decode tokens/s: Engine "
            f"{a['throughput']['decode_tokens_per_s']:.1f}, PagedEngine "
            f"{b['throughput']['decode_tokens_per_s']:.1f}; prefill tokens/s: "
            f"Engine {a['throughput']['prefill_tokens_per_s']:.1f}, "
            f"PagedEngine (chunks) "
            f"{b['throughput']['prefill_tokens_per_s']:.1f}")
        del m, a, b
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 9: whisper-base served, bert-110m's forward
# ---------------------------------------------------------------------------

def expected_whisper_launches(cfg, steps: int) -> dict:
    """One generate: per encoder layer 4 gemm_fused (q|k, v, up, down) and
    one flash forward; per decoder layer in the prefill 4 gemm_fused and 2
    flash forwards (causal self, cross; the cross projections are plain
    products, as in the reference); per decoder layer and decode step 2
    gemm_fused and 2 flash_decode (self, cross)."""
    enc, dec = cfg.encoder_layers, cfg.num_layers
    return {**no_launches(),
            "gemm_fused": 4 * enc + 4 * dec + 2 * dec * steps,
            "flash_attention_fwd": enc + 2 * dec,
            "flash_decode": 2 * dec * steps}


def whisper_teacher_forced(model, params, tokens, emb):
    """Per-step logits (W_BATCH, V) fp32 of ``tokens`` (B, W_PROMPT +
    W_NEW): encode and prefill the prompt, then decode the given tokens."""
    out = []
    with torch.inference_mode():
        cache = model.init_cache(tokens.shape[0], W_MAX_LEN)
        cache, logits = model.prefill(
            params, {"encoder_embeds": emb, "inputs": tokens[:, :W_PROMPT]},
            cache)
        out.append(logits.float())
        for i in range(W_NEW - 1):
            pos = W_PROMPT + i
            cache, logits = model.decode_step(
                params, tokens[:, pos:pos + 1], cache, pos)
            out.append(logits.float())
    return out


def run_whisper(dev) -> dict:
    """9a: whisper-base whole (6 + 6 layers) at a trained model's scale, as
    phase 8's weights, through Engine.generate: batch 4, 64-token prompts,
    32 new tokens, greedy, seeded encoder_embeds (4, 1500, 512) in
    extra_batch. Launches exact; one replayed decode step bit for bit the
    eager step (logits and the self cache, the cross cache unchanged);
    teacher-forced logits within phase 4's bound."""
    m = build_models(dev, "whisper-base", trained=True)
    cfg, params = m.cfg, m.params
    rng = np.random.default_rng(9)
    emb = torch.from_numpy(rng.standard_normal(
        (W_BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).to(
        dev, torch.bfloat16)
    extra = {"encoder_embeds": emb}
    engine = Engine(m.kernel, params, max_len=W_MAX_LEN)
    # one warm-up batch of the served shape: the decode graph's capture
    engine.generate(rng.integers(0, cfg.vocab_size, (W_BATCH, W_PROMPT)), 2,
                    extra_batch=extra)
    engine.timings.clear()
    prompts = rng.integers(0, cfg.vocab_size, (W_BATCH, W_PROMPT))
    kernels.reset_launch_counts()
    result = engine.generate(prompts, W_NEW, extra_batch=extra)
    counts = kernels.launch_counts()
    want = expected_whisper_launches(cfg, W_NEW - 1)
    log(f"[9a] whisper-base served {W_BATCH} x {W_PROMPT} + {W_NEW}; "
        f"launches {counts}; bucket_lru {engine.lru_stats}")
    if counts != want:
        raise AssertionError(f"[9a] launches {counts}; the path makes {want}")
    toks = result.tokens
    if toks.shape != (W_BATCH, W_PROMPT + W_NEW) or not np.array_equal(
            toks[:, :W_PROMPT], prompts) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"[9a] bad result {toks}")
    entry = engine._buckets[("decode", W_BATCH)]
    token = torch.arange(W_BATCH, device=dev)[:, None] * 7 + 1
    cross = tree_map(torch.clone, entry.cache["cross"])

    def eager(cache):
        return m.kernel.decode_step(params, token, cache, W_PROMPT + 3)[1]
    check_graph_replay("9a", entry, entry.cache,
                       dict(token=token, pos=W_PROMPT + 3), eager)
    if not all(torch.equal(entry.cache["cross"][k], cross[k])
               for k in cross):
        raise AssertionError("[9a] a decode step wrote the cross cache")
    t = engine.timings[0]
    throughput = {"encode_prefill_s": t["prefill_s"],
                  "decode_s": t["decode_s"],
                  "decode_tokens_per_s": W_BATCH * (W_NEW - 1) / t[
                      "decode_s"]}
    log(f"[9a] encode + prefill {t['prefill_s']:.4f} s; decode "
        f"{W_BATCH * (W_NEW - 1)} tokens in {t['decode_s']:.4f} s "
        f"({throughput['decode_tokens_per_s']:.1f} tok/s); the cross cache "
        f"unchanged by the steps")
    tokens = torch.as_tensor(toks, dtype=torch.int64, device=dev)
    kern = whisper_teacher_forced(m.kernel, params, tokens, emb)
    greedy = torch.stack([lg.argmax(-1) for lg in kern], dim=1)
    if not torch.equal(greedy, tokens[:, W_PROMPT:]):
        raise AssertionError("[9a] the served greedy tokens differ from the "
                             "argmax of the kernel path's teacher-forced "
                             "logits")
    plain = whisper_teacher_forced(m.plain, params, tokens, emb)
    truth = whisper_teacher_forced(m.truth, m.params32, tokens, emb)
    worst, agreement = check_logit_bound("9a", kern, plain, truth)
    log(f"[9a] teacher-forced logits over {len(kern)} steps: kernel-path "
        f"error vs fp32 at most {worst:.3f} of its bound; greedy agreement "
        f"with the plain bf16 path {agreement:.3f} (information only)")
    del m
    return {"launches": counts, "throughput": throughput,
            "bucket_lru": dict(engine.lru_stats), "logit_bound_use": worst,
            "greedy_agreement": agreement}


def run_bert(dev) -> dict:
    """9b: bert-110m whole (12 layers) at a trained model's scale, its MLM
    forward on 8 x 512 seeded tokens: launches exact (per layer 4
    gemm_fused and one non-causal flash forward), the logits within phase
    4's bound of fp32, tokens/s of the kernel path (median of 5 forwards
    after a warm-up, each ended by a synchronise)."""
    m = build_models(dev, "bert-110m", trained=True)
    cfg = m.cfg
    rng = np.random.default_rng(10)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (B_BATCH, B_SEQ)), device=dev)
    with torch.inference_mode():
        m.kernel.forward(m.params, tokens)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        kern = m.kernel.forward(m.params, {"inputs": tokens})
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = {**no_launches(), "gemm_fused": 4 * cfg.num_layers,
                "flash_attention_fwd": cfg.num_layers}
        if counts != want:
            raise AssertionError(f"[9b] launches {counts}; the path makes "
                                 f"{want}")
        secs = []
        for _ in range(5):
            t0 = time.perf_counter()
            m.kernel.forward(m.params, tokens)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        plain = m.plain.forward(m.params, tokens)
        truth = m.truth.forward(m.params32, tokens)
        worst, agreement = check_logit_bound(
            "9b", [kern.float()], [plain.float()], [truth.float()])
    step = statistics.median(secs)
    log(f"[9b] bert-110m forward {B_BATCH} x {B_SEQ}: launches {counts}; "
        f"{step:.4f} s ({B_BATCH * B_SEQ / step:.1f} tok/s, median of 5); "
        f"logits vs fp32 at most {worst:.3f} of the bound; argmax agreement "
        f"with the plain bf16 path {agreement:.3f} (information only)")
    del m, kern, plain, truth
    return {"launches": counts, "forward_s": step,
            "tokens_per_s": B_BATCH * B_SEQ / step,
            "logit_bound_use": worst, "argmax_agreement": agreement}


# ---------------------------------------------------------------------------
# Phases 9c, 9d: bert-110m and whisper-base trained
# ---------------------------------------------------------------------------

def mlm_batches(cfg, dev):
    """bert's masked-LM batches: the LM pipeline's B_BATCH x B_SEQ tokens as
    the targets, MLM_MASK of the positions masked to id 0 (the [MASK] id of
    tests/test_models.py::test_bert_mlm_smoke) in the inputs, the loss on
    those; batch i's mask drawn from a generator seeded with i."""
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=B_SEQ,
                                   global_batch=B_BATCH), device=dev)
    for step in itertools.count():
        targets = next(data)["targets"]
        gen = torch.Generator(device=dev).manual_seed(step)
        mask = torch.rand(targets.shape, generator=gen,
                          device=dev) < MLM_MASK
        yield {"inputs": torch.where(mask, 0, targets), "targets": targets,
               "loss_mask": mask.float()}


def whisper_batches(cfg, dev):
    """whisper's batches: the LM pipeline's W_TRAIN_BATCH x W_TRAIN_SEQ
    decoder tokens over one seeded encoder_embeds (W_TRAIN_BATCH, 1500,
    512), fp32 (the model casts them to its compute type)."""
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=W_TRAIN_SEQ,
                                   global_batch=W_TRAIN_BATCH), device=dev)
    emb = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (W_TRAIN_BATCH, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)).to(dev)
    while True:
        yield dict(next(data), encoder_embeds=emb)


def expected_encoder_train_launches(cfg, steps: int) -> dict:
    """Per layer and step under remat_policy='full', as phase 6b's: 4
    GEMMs (q|k, v, up, down) in the forward and again in the recompute,
    each GEMM's backward as operand pass, dA and dB; per attention a flash
    forward in each of the two passes and the flash backward's two
    launches. An encoder layer has one attention, a decoder layer two (its
    causal self attention and the cross attention, whose projections are
    plain products)."""
    layers = cfg.num_layers + cfg.encoder_layers
    attn = (2 * cfg.num_layers + cfg.encoder_layers
            if cfg.family == "encdec" else cfg.num_layers)
    return {**no_launches(), "gemm_fused": 8 * layers * steps,
            "flash_attention_fwd": 2 * attn * steps,
            "gemm_bwd_g": 4 * layers * steps,
            "gemm_bwd_da": 4 * layers * steps,
            "gemm_bwd_db": 4 * layers * steps,
            "flash_attention_bwd": 2 * attn * steps}


def run_encoder_training(dev, phase: str, arch: str, batches, seq: int):
    """Phase 9c (bert-110m) or 9d (whisper-base), whole, weights at a
    trained model's scale (as 6a's). (1) One batch's per-leaf grads of
    ``Model.loss`` in kernel mode, plain bf16 and fp32: every leaf's kernel
    error against fp32 within 2x the plain bf16 error + 1e-3, launches
    exact. (2) ENC_TRAIN_STEPS steps of ``train_loop`` in each mode
    (cosine_schedule, 2 warm-up steps): every loss finite, launches exact,
    the kernel curve within 2.5x the plain bf16 curve's distance from fp32
    + 0.05. (3) tokens/s (the median step after the first), the peak
    device memory and one traced step's device-busy share."""
    cfg = get_config(arch)
    tokens = next(batches(cfg, dev))["targets"].numel()

    def weights(model):
        return trained_scale(model, model.init(seed=0,
                                                dtype=cfg.param_dtype))

    def built(mode, dtype):
        return build_model(dataclasses.replace(cfg, compute_dtype=dtype),
                           mode=mode, device=dev)

    batch = next(batches(cfg, dev))

    def grads(mode, dtype):
        model = built(mode, dtype)
        params = tree_map(lambda t: t.requires_grad_(), weights(model))
        kernels.reset_launch_counts()
        loss, _, g = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        named = {path: x.float() for (path, _), x
                 in zip(named_leaves(params), g)}
        return float(loss), named, kernels.launch_counts()

    k_loss, kern, counts = grads("kernel", "bfloat16")
    want = expected_encoder_train_launches(cfg, 1)
    if counts != want:
        raise AssertionError(f"[{phase}] launches {counts}; one step of "
                             f"{arch} makes {want}")
    p_loss, plain, _ = grads("reference", "bfloat16")
    t_loss, truth, _ = grads("reference", "float32")
    worst, per_leaf = 0.0, {}
    for path, t_ in truth.items():
        k_err = (kern[path] - t_).abs().max().item()
        p_err = (plain[path] - t_).abs().max().item()
        per_leaf[path] = {"kernel_err": k_err, "plain_err": p_err,
                          "truth_max": t_.abs().max().item()}
        if not k_err <= 2.0 * p_err + 1e-3:
            raise AssertionError(f"[{phase}] {path}: kernel-mode grad "
                                 f"{k_err:.4g} from fp32, plain bf16 "
                                 f"{p_err:.4g}")
        worst = max(worst, k_err / (2.0 * p_err + 1e-3))
    del kern, plain, truth
    log(f"[{phase}] {arch} whole, weights at std fan_in^-1/2, {tokens} "
        f"tokens: loss kernel {k_loss:.5f}, plain bf16 {p_loss:.5f}, fp32 "
        f"{t_loss:.5f}; every one of {len(per_leaf)} leaves' kernel-mode "
        f"grad error within its bound (2 x plain bf16 error + 1e-3), at most "
        f"{worst:.3f} of it; launches {counts}")

    def curve(mode, dtype):
        model = built(mode, dtype)
        opt = AdamWConfig(schedule=cosine_schedule(TRAIN_LR, 2,
                                                   ENC_TRAIN_STEPS))
        params = weights(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        res = train_loop(model, batches(cfg, dev), ENC_TRAIN_STEPS, opt,
                         seed=0, params=params, log_every=0)
        out = {"losses": res.losses, "step_seconds": res.step_seconds,
               "launches": kernels.launch_counts(),
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del res, params, model
        torch.cuda.empty_cache()
        return out

    kcurve = curve("kernel", "bfloat16")
    losses = kcurve["losses"]
    want = expected_encoder_train_launches(cfg, ENC_TRAIN_STEPS)
    if kcurve["launches"] != want:
        raise AssertionError(f"[{phase}] launches {kcurve['launches']}; "
                             f"{ENC_TRAIN_STEPS} steps make {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[{phase}] losses {losses}: not finite")
    step_s = statistics.median(kcurve["step_seconds"][1:])
    pcurve = curve("reference", "bfloat16")
    tcurve = curve("reference", "float32")
    k_err = float(np.abs(np.subtract(losses, tcurve["losses"])).max())
    p_err = float(np.abs(np.subtract(pcurve["losses"],
                                     tcurve["losses"])).max())
    log(f"[{phase}] {ENC_TRAIN_STEPS} steps of {tokens} tokens: kernel "
        f"losses {[round(x, 4) for x in losses]}, plain bf16 "
        f"{[round(x, 4) for x in pcurve['losses']]}, fp32 "
        f"{[round(x, 4) for x in tcurve['losses']]}; the kernel curve is "
        f"{k_err:.4g} from fp32, the plain bf16 curve {p_err:.4g} (bound "
        f"2.5 x {p_err:.4g} + 0.05)")
    if not k_err <= 2.5 * p_err + 0.05:
        raise AssertionError(f"[{phase}] kernel curve {k_err:.4g} from the "
                             f"fp32 truth, plain bf16 {p_err:.4g}")
    prof = profile_step(build_model(cfg, mode="kernel", device=dev),
                        batch["targets"].shape[0], seq, warmup=1)
    tr = prof["traced"]
    log(f"[{phase}] step time {step_s:.4f} s (median of the steps after the "
        f"first), {tokens / step_s:.1f} tokens/s; peak device memory "
        f"{kcurve['peak_memory_gb']:.2f} GB; one traced step: device busy "
        f"{tr['device_busy_ms']:.1f} of {tr['traced_wall_ms']:.1f} ms "
        f"({tr['device_busy_share']:.3f}); device ms by family "
        f"{ {k: round(v, 2) for k, v in tr['device_ms_by_family'].items()} }")
    return {"launches": kcurve["launches"], "grad_launches": counts,
            "grad_bound_use": worst, "leaves": per_leaf,
            "grad_losses": {"kernel": k_loss, "plain": p_loss,
                            "truth": t_loss},
            "kernel": kcurve, "plain": pcurve, "truth": tcurve,
            "curve_err": {"kernel": k_err, "plain": p_err},
            "step_s": step_s, "tokens_per_s": tokens / step_s,
            "profile": prof}


# ---------------------------------------------------------------------------
# Phase 10: greedy speculative decoding in PagedEngine
# ---------------------------------------------------------------------------

# phase -> (the phase 5 traffic and engine options it takes, the draft)
SPEC_RUNS = {"10a": ("5a", "self"), "10b": ("5a", "skip"),
             "10c": ("5b", "self")}
# room for every bucket of a phase (prefill keys of 16 prompt lengths and
# their draft twins beside the round's), for the plain engine alike
SPEC_CAP = 64


def expected_spec_launches(engine) -> dict:
    """What a speculative engine's counters imply: per target and draft
    layer 4 fused GEMMs and one flash prefill per exact-length prefill, 4
    fused GEMMs and one paged launch per chunk; per round k draft steps
    and one verify, each 2 fused GEMMs and one paged launch a layer."""
    lt, ld = engine.model.cfg.num_layers, engine.draft_model.cfg.num_layers
    pre, chunks = engine.prefills, engine.chunks_prefilled
    steps = engine.spec_rounds * (lt + engine.spec_tokens * ld)
    return {**no_launches(),
            "gemm_fused": 4 * (lt + ld) * (pre + chunks) + 2 * steps,
            "flash_attention_fwd": (lt + ld) * pre,
            "flash_decode_paged": (lt + ld) * chunks + steps}


def spec_serve(model, params, reqs, kw) -> tuple:
    """A warm-up engine of the same options (two short requests: cuBLAS
    plans, the allocator), then ``reqs`` through a fresh one with every
    launch counter zeroed just before and read just after. (engine,
    results, counts)."""
    warm = PagedEngine(model, params, **kw)
    for u in range(2):
        warm.submit(Request(u, np.arange(1, 100 + u, dtype=np.int32), 3))
    warm.run()
    engine = PagedEngine(model, params, **kw)
    for r in reqs:
        engine.submit(r)
    kernels.reset_launch_counts()
    results = engine.run()
    torch.cuda.synchronize()
    return engine, results, kernels.launch_counts()


def route_distance(plain_engine, model, params, row, plen: int, pos: int,
                   chunk, preempted: bool, dev) -> tuple:
    """At stream position ``pos`` (> plen) of a plain stream ``row``: the
    serial route's top-2 logit margin there, and the logit distance between
    the routes the two engines can take to it: serial decode steps against
    verify steps (paged_replay by blocks), and for a request preempted in
    either engine also against a re-prefill of everything before ``pos``
    (a recompute preemption's route)."""
    serial = paged_replay(plain_engine, model, params, row[:pos + 1], plen,
                          chunk, dev)[pos - plen]
    blocked = paged_replay(plain_engine, model, params, row[:pos + 1], plen,
                           chunk, dev, SPEC_TOKENS)[pos - plen]
    dist = (blocked - serial).abs().max().item()
    if preempted:
        cache = model.init_paged_cache(1, MAX_PAGES + 1, PAGE)
        with torch.inference_mode():
            _, logits = model.prefill_paged(
                params, torch.as_tensor(np.asarray(row[None, :pos], np.int64),
                                        device=dev), cache,
                np.arange(1, MAX_PAGES + 1, dtype=np.int32), 0, pos)
        dist = max(dist, (logits[0].float() - serial).abs().max().item())
    top = torch.topk(serial, 2).values
    return (top[0] - top[1]).item(), dist


def run_spec(dev) -> dict:
    """Phase 10: llama-1b whole, weights at a trained model's scale (as
    phase 8's), kernel mode, spec_tokens SPEC_TOKENS; phase 5a's traffic
    with the self-draft (a) and the layer-skip draft (b: the target's
    embedding, final norm and first SKIP_LAYERS blocks, views of its
    stacked leaves), phase 5b's (shared prefix, prefix cache, chunks) with
    the self-draft (c); each beside the plain PagedEngine on the same
    weights and traffic (phase 5 serves the reference's init, so it runs
    again here). First one served stream by verify steps against serial
    steps in a lone slot (paged_replay by blocks of 1 and of k): their
    logits' distance, the record of whether a verify row is the serial
    step's bits.
    Checks: completion and pool accounting; every stream equal to the plain
    engine's, or a difference explained (the plain step's top-2 margin at
    the first differing position under the logit distance of the routes
    there, route_distance); the self-draft accepting every proposal unless
    the routes' logits differ; exact launches;
    ``bucket_lru`` and the draft and verify keys; one replayed verify step
    bit for bit the eager T = k step; decode tokens/s beside the plain
    engine's."""
    cfg = get_config("llama-1b")
    model = build_model(cfg, mode="kernel", device=dev)
    params = trained_scale(model, model.init(seed=0))
    skip = build_model(dataclasses.replace(cfg, num_layers=SKIP_LAYERS),
                       mode="kernel", device=dev)
    skip_params = {**params, "blocks": tree_map(lambda x: x[:SKIP_LAYERS],
                                                params["blocks"])}
    drafts = {"self": (model, params), "skip": (skip, skip_params)}
    base_kw = dict(batch_slots=SLOTS, page_size=PAGE,
                   max_pages_per_seq=MAX_PAGES, max_cached_buckets=SPEC_CAP)
    plain = {}
    for traffic in ("5a", "5b"):
        kw = dict(base_kw, **PHASES[traffic])
        plain[traffic] = spec_serve(model, params,
                                    paged_requests(cfg, traffic), kw)
        eng = plain[traffic][0]
        log(f"[10 plain {traffic}] trained-scale weights: "
            f"{eng.report()['decode_steps']} decode steps, "
            f"{eng.preemptions} preemptions, decode "
            f"{eng.timings['decode_tokens'] / eng.timings['decode_s']:.1f} "
            f"tok/s")

    # the speculative route against the serial one over a served stream,
    # in a lone slot of the SLOTS-row launches the engine makes
    p_eng, p_res, _ = plain["5a"]
    r0 = paged_requests(cfg, "5a")[0]
    row0, plen0 = p_res[r0.uid], len(r0.prompt)
    serial = paged_replay(p_eng, model, params, row0, plen0, None, dev)
    blocked = paged_replay(p_eng, model, params, row0, plen0, None, dev,
                           SPEC_TOKENS)
    step_diff = max((x - y).abs().max().item()
                    for x, y in zip(blocked, serial))
    log(f"[10] request {r0.uid}'s {len(serial)} tokens by verify steps (T "
        f"{SPEC_TOKENS}) against serial decode steps, lone slot: logits "
        + ("equal bit for bit" if step_diff == 0 else
           f"DIFFER, max |diff| {step_diff:.4g}") + "; greedy tokens "
        + ("equal" if all(int(x.argmax()) == int(y.argmax())
                          for x, y in zip(blocked, serial)) else "DIFFER"))
    out = {"verify_vs_serial_logit_diff": step_diff}

    for phase, (traffic, draft) in SPEC_RUNS.items():
        d_model, d_params = drafts[draft]
        kw = dict(base_kw, **PHASES[traffic], draft_model=d_model,
                  draft_params=d_params, spec_tokens=SPEC_TOKENS)
        reqs = paged_requests(cfg, traffic)
        engine, results, counts = spec_serve(model, params, reqs, kw)
        p_eng, p_res, _ = plain[traffic]
        rep = engine.report()
        spec = rep["speculative"]
        want = expected_spec_launches(engine)
        log(f"[{phase}] {draft}-draft on phase {traffic}'s traffic: served "
            f"{len(results)} requests in {spec['rounds']} rounds, "
            f"{rep['prefills']} exact prefills, {engine.chunks_prefilled} "
            f"chunks, {rep['preemptions']} preemptions, peak "
            f"{rep['peak_pages_in_use']} of {rep['page_pool_size']} pages; "
            f"speculative {spec}; launches {counts}; bucket_lru "
            f"{rep['bucket_lru']}")
        if counts != want:
            raise AssertionError(f"[{phase}] launches {counts}; the engine's "
                                 f"counters imply {want}")
        if sorted(results) != [r.uid for r in reqs]:
            raise AssertionError(f"[{phase}] completed {sorted(results)}")
        for r in reqs:
            check_result(cfg, r, results[r.uid])
        held = rep.get("prefix_cache", {}).get("pages_held", 0)
        if engine.alloc.free_pages != engine.n_pages - 1 - held:
            raise AssertionError(f"[{phase}] {engine.alloc.free_pages} pages "
                                 f"free, {held} held by the trie, of "
                                 f"{engine.n_pages - 1}")
        kinds = {k[0] for k in engine._buckets if isinstance(k[0], str)}
        if not {"verify", "draft_decode"} <= kinds or not kinds & {
                "draft_prefill", "draft_chunk"}:
            raise AssertionError(f"[{phase}] cached bucket kinds {kinds}")
        if phase == "10a" and rep["preemptions"] < 1:
            raise AssertionError(f"[{phase}] the pool never forced a "
                                 "preemption")
        if traffic == "5b" and (rep["prefix_cache"]["hits"] < 1
                                or engine.chunks_prefilled < 1):
            raise AssertionError(f"[{phase}] prefix hits "
                                 f"{rep['prefix_cache']['hits']}, chunks "
                                 f"{engine.chunks_prefilled}")
        if not 1.0 <= spec["mean_tokens_per_round"] <= SPEC_TOKENS:
            raise AssertionError(f"[{phase}] {spec}")
        if draft == "self" and (spec["accept_rate"] != 1.0 or
                                spec["mean_tokens_per_round"] != SPEC_TOKENS):
            if step_diff == 0:
                raise AssertionError(
                    f"[{phase}] the self-draft's proposals were rejected "
                    f"({spec}) where a verify step is the serial steps' bits")
            log(f"[{phase}] the self-draft accepts {spec['accept_rate']:.4f}"
                f" of its proposals: the speculative route's logits differ "
                f"from the serial route's (by {step_diff:.4g} over request "
                f"{r0.uid})")

        differ = []
        chunk = kw.get("chunk_tokens")
        for r in reqs:
            got, ref = results[r.uid], p_res[r.uid]
            if np.array_equal(got, ref):
                continue
            pos = int(np.nonzero(got != ref)[0][0])
            preempted = r.uid in set(rep["preempted_uids"]) | set(
                p_eng.report()["preempted_uids"])
            margin, dist = route_distance(p_eng, model, params, ref,
                                          len(r.prompt), pos, chunk,
                                          preempted, dev)
            log(f"[{phase}] request {r.uid}"
                + (" (preempted)" if preempted else "")
                + f": first differs from the plain engine at position {pos}; "
                f"the plain step's top-2 margin {margin:.4g}, the routes' "
                f"logit distance there {dist:.4g}")
            if not margin < dist:
                raise AssertionError(f"[{phase}] request {r.uid}'s stream "
                                     "differs where the margin exceeds the "
                                     "verify-vs-serial distance")
            differ.append({"uid": r.uid, "position": pos, "margin": margin,
                           "distance": dist, "preempted": preempted})
        log(f"[{phase}] {len(reqs) - len(differ)} of {len(reqs)} streams "
            "equal the plain PagedEngine's token for token")

        key = next(k for k in engine._buckets if k[0] == "verify")
        mp = key[1]
        # the idle rows' equal tokens write equal values to the null page
        token = torch.zeros((SLOTS, SPEC_TOKENS), dtype=torch.int64,
                            device=dev)
        token[0] = torch.arange(SPEC_TOKENS, device=dev) * 13 + 5
        table = torch.zeros((SLOTS, mp), dtype=torch.int32, device=dev)
        table[0] = torch.arange(1, mp + 1, dtype=torch.int32)
        lengths = torch.zeros((SLOTS,), dtype=torch.int32, device=dev)
        lengths[0] = mp * PAGE - SPEC_TOKENS - 3

        def eager(pools):
            return model.decode_step_paged(params, token, pools, table,
                                           lengths)[1]
        check_graph_replay(f"{phase} bucket {key}", engine._buckets[key],
                           engine.cache, dict(token=token, page_table=table,
                                              lengths=lengths), eager)
        t, pt = engine.timings, p_eng.timings
        tps = t["decode_tokens"] / t["decode_s"]
        p_tps = pt["decode_tokens"] / pt["decode_s"]
        log(f"[{phase}] decode {t['decode_tokens']} tokens in "
            f"{t['decode_s']:.4f} s ({tps:.1f} tok/s) against the plain "
            f"engine's {pt['decode_tokens']} in {pt['decode_s']:.4f} s "
            f"({p_tps:.1f} tok/s, {p_eng.decode_steps} steps); prefill "
            f"{t['prefill_s']:.4f} s against {pt['prefill_s']:.4f} s")
        out[phase] = {"report": rep, "launches": counts, "differ": differ,
                      "decode_tokens_per_s": tps,
                      "plain_decode_tokens_per_s": p_tps,
                      "plain_decode_steps": p_eng.decode_steps,
                      "timings": dict(t), "plain_timings": dict(pt)}
        del engine, results
    return out


# ---------------------------------------------------------------------------
# Phase 11: the training leftovers
# ---------------------------------------------------------------------------

def expected_kept_launches(cfg, steps: int, policy: str) -> dict:
    """Per layer and step under remat_policy 'dots': the 4 forward GEMMs
    once (their outputs kept), the flash forward twice (recomputed with
    the rest of the block); under 'none' both once; the backward as under
    'full' (expected_train_launches)."""
    n = cfg.num_layers * steps
    return {**expected_train_launches(cfg, steps), "gemm_fused": 4 * n,
            "flash_attention_fwd": (2 if policy == "dots" else 1) * n}


def held_to_truth(tag: str, run: dict, truth: list, plain: list) -> dict:
    """The curve of ``run`` within 2.5x the plain bf16 curve's distance
    from the fp32 ``truth`` + 0.05, every loss finite and the last below
    the first."""
    losses = run["losses"]
    k_err = float(np.abs(np.subtract(losses, truth)).max())
    p_err = float(np.abs(np.subtract(plain, truth)).max())
    log(f"[{tag}] losses {[round(x, 4) for x in losses]}: {k_err:.4g} from "
        f"the fp32 curve, the plain bf16 curve {p_err:.4g} (bound 2.5 x "
        f"{p_err:.4g} + 0.05)")
    if (not all(np.isfinite(losses)) or not losses[-1] < losses[0]
            or not k_err <= 2.5 * p_err + 0.05):
        raise AssertionError(f"[{tag}] losses {losses}: {k_err:.4g} from "
                             f"the fp32 truth, plain bf16 {p_err:.4g}")
    return {"kernel": k_err, "plain": p_err}


def loss_peak_gb(cfg, dev) -> float:
    """The peak device memory (GB) of one ``loss_and_grads`` of 6b's first
    batch in kernel mode: the fp32 masters, the activations, the logits and
    the grads, without the optimizer's moments and temporaries (which set
    the peak of a whole train step)."""
    model = build_model(cfg, mode="kernel", device=dev)
    params = tree_map(lambda t: t.requires_grad_(),
                      model.init(seed=0, dtype=cfg.param_dtype))
    batch = next(train_data(cfg, dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    grads = loss_and_grads(model, params, batch)[2]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del grads, params, model
    torch.cuda.empty_cache()
    return peak


def run_lever(dev, tag: str, curves: dict, want_fn, **cfg_kw) -> dict:
    """11a, 11b: 6b's 16 layers, steps, data and seed in kernel mode with
    ``cfg_kw`` (a training lever): launches exact, the curve held to 6b's
    fp32 and plain bf16 curves (the function is 6b's), step time and peak
    memory beside 6b's, and one traced step's device ms by family."""
    cfg = dataclasses.replace(get_config("llama-1b"), **cfg_kw)
    run = train_curve(cfg, "kernel", "bfloat16", dev)
    want = want_fn(cfg)
    if run["launches"] != want:
        raise AssertionError(f"[{tag}] launches {run['launches']}; "
                             f"{TRAIN_STEPS} steps make {want}")
    err = held_to_truth(tag, run, curves["truth"]["losses"],
                        curves["plain"]["losses"])
    step_s = statistics.median(run["step_seconds"][1:])
    base = curves["kernel"]
    loss_peak = loss_peak_gb(cfg, dev)
    prof = profile_step(build_model(cfg, mode="kernel", device=dev),
                        TRAIN_BATCH, TRAIN_SEQ, warmup=1)
    tr = prof["traced"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[{tag}] {cfg_kw}: step {step_s:.4f} s ({tokens / step_s:.1f} "
        f"tokens/s), peak device memory "
        f"{run['peak_memory_gb']:.2f} GB, of the loss and grads alone "
        f"{loss_peak:.2f} GB; 6b (remat 'full', unchunked) "
        f"{curves['step_s']:.4f} s, {base['peak_memory_gb']:.2f} GB, "
        f"{curves['loss_peak_gb']:.2f} GB; launches "
        f"exact {run['launches']}; one traced step: device busy "
        f"{tr['device_busy_ms']:.1f} of {tr['traced_wall_ms']:.1f} ms "
        f"({tr['device_busy_share']:.3f}); device ms by family "
        f"{ {k: round(v, 2) for k, v in tr['device_ms_by_family'].items()} }")
    return {**run, "curve_err": err, "step_s": step_s,
            "loss_peak_gb": loss_peak, "profile": prof}


class KeptSnapshots(ckpt_lib.AsyncCheckpointer):
    """The AsyncCheckpointer that also keeps, on the card, a copy of the
    state as it stood at the save of each step in ``steps``: what its
    checkpoint must hold bit for bit."""

    def __init__(self, directory: str, keep: int, steps: tuple):
        super().__init__(directory, keep)
        self.steps, self.kept = steps, {}

    def save(self, state, step: int) -> None:
        if step in self.steps and step not in self.kept:
            self.kept[step] = {k: v.detach().clone() if torch.is_tensor(v)
                               else v for k, v in named_leaves(state)}
        super().save(state, step)


@dataclasses.dataclass
class StepSpans(StragglerWatchdog):
    """The watchdog that also records each step's (start, end) on
    ``time.perf_counter``'s clock."""
    spans: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        end = time.perf_counter()
        self.spans.append((end - seconds, end))
        return super().observe(step, seconds)


def run_checkpoint(dev) -> dict:
    """11c: llama-1b's width at SHORT_LAYERS layers, SHORT_STEPS steps of
    train_loop with a checkpoint every CKPT_EVERY steps (keep CKPT_KEEP)
    and a failure injected at step CKPT_FAIL, in a temporary directory
    removed at the end; beside it the same steps uninterrupted."""
    cfg = dataclasses.replace(get_config("llama-1b"), num_layers=SHORT_LAYERS)
    model = build_model(cfg, mode="kernel", device=dev)
    opt = AdamWConfig(schedule=cosine_schedule(TRAIN_LR, 2, TRAIN_STEPS))
    plain = train_loop(model, train_data(cfg, dev), SHORT_STEPS, opt, seed=0,
                       log_every=0)
    ref = {"losses": plain.losses, "step_seconds": plain.step_seconds}
    del plain
    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(directory).free
    log(f"[11c] checkpoint directory {directory}: {free / 1e9:.1f} GB free "
        f"before the phase")
    try:
        ac = KeptSnapshots(directory, CKPT_KEEP, (CKPT_RESUME,))
        spans, logs = StepSpans(), []
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        res = train_loop(model, train_data(cfg, dev), SHORT_STEPS, opt,
                         seed=0, checkpointer=ac, ckpt_every=CKPT_EVERY,
                         failure_injector=FailureInjector((CKPT_FAIL,)),
                         watchdog=spans, log_every=0, log=logs.append)
        counts = kernels.launch_counts()
        steps_run = CKPT_FAIL + SHORT_STEPS - CKPT_RESUME
        want = expected_train_launches(cfg, steps_run)
        if counts != want:
            raise AssertionError(f"[11c] launches {counts}; {steps_run} "
                                 f"steps make {want}")
        if (res.restarts != 1 or f"[trainer] restored step {CKPT_RESUME}"
                not in logs or len(res.losses) != steps_run):
            raise AssertionError(f"[11c] restarts {res.restarts}, log {logs}")
        avail = ckpt_lib.available_steps(directory)
        want_avail = [SHORT_STEPS - CKPT_EVERY, SHORT_STEPS]
        if avail != want_avail:
            raise AssertionError(f"[11c] available steps {avail}, keep "
                                 f"{CKPT_KEEP} leaves {want_avail}")
        restored, _ = ckpt_lib.restore(directory, res.state, step=CKPT_RESUME)
        kept = ac.kept[CKPT_RESUME]
        for path, x in named_leaves(restored):
            same = (torch.equal(x, kept[path]) if torch.is_tensor(x)
                    else x == kept[path])
            if not same:
                raise AssertionError(f"[11c] {path} of step {CKPT_RESUME} "
                                     "differs from the state at its save")
        del restored, kept
        after = res.losses[CKPT_FAIL:]
        base = ref["losses"][CKPT_RESUME:]
        rel = max(abs(a - b) / abs(b) for a, b in zip(after, base))
        if not rel <= 1e-3:
            raise AssertionError(f"[11c] losses after the restore {after}, "
                                 f"uninterrupted {base}: {rel:.3g} relative")
        recs = ac.records
        overlapped, alone = [], []
        for i, ((t0, t1), dt) in enumerate(zip(spans.spans,
                                               res.step_seconds)):
            if any(r["write_start"] < t1 and t0 < r["write_end"]
                   for r in recs):
                overlapped.append(dt)
            elif i:
                alone.append(dt)
        state_bytes = sum(x.numel() * x.element_size()
                          for x in leaves(res.state) if torch.is_tensor(x))
        log(f"[11c] {cfg.num_layers} layers, {SHORT_STEPS} steps, a "
            f"checkpoint every {CKPT_EVERY} (keep {CKPT_KEEP}), failure at "
            f"step {CKPT_FAIL}: restarts {res.restarts}, resumed at step "
            f"{CKPT_RESUME}, its state bit for bit the state at its save; "
            f"available steps {avail}; losses after the restore "
            f"{[round(x, 5) for x in after]}, uninterrupted "
            f"{[round(x, 5) for x in base]} ({rel:.3g} relative); launches "
            f"exact {counts}")
        log(f"[11c] state {state_bytes / 1e9:.3f} GB; saves (step, bytes "
            f"written, snapshot s, background write s): "
            f"{[(r['step'], r['bytes'], round(r['snapshot_s'], 4), round(r['write_s'], 3)) for r in recs]}")
        log(f"[11c] step seconds overlapping a write "
            f"{[round(x, 4) for x in overlapped]}, not overlapping (after "
            f"the first) {[round(x, 4) for x in alone]}; uninterrupted run "
            f"{[round(x, 4) for x in ref['step_seconds']]}")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return {"launches": counts, "losses": res.losses, "uninterrupted": ref,
            "restarts": res.restarts, "available_steps": avail,
            "restore_rel_err": rel, "records": recs, "free_bytes": free,
            "state_bytes": state_bytes, "overlapped_step_s": overlapped,
            "alone_step_s": alone}


def run_compression(dev, short: dict) -> dict:
    """11d: grad_compress=True at 11c's width and depth, SHORT_STEPS steps
    in kernel mode, plain bf16 and plain fp32, each with compression; the
    kernel curve held to the compressed fp32 curve (compression changes
    the function), launches exact; the residuals' bytes and the step time
    beside 11c's uninterrupted (uncompressed) run."""
    cfg = dataclasses.replace(get_config("llama-1b"), num_layers=SHORT_LAYERS)
    kern = train_curve(cfg, "kernel", "bfloat16", dev, steps=SHORT_STEPS,
                       grad_compress=True)
    want = expected_train_launches(cfg, SHORT_STEPS)
    if kern["launches"] != want:
        raise AssertionError(f"[11d] launches {kern['launches']}; "
                             f"{SHORT_STEPS} steps make {want}")
    plain = train_curve(cfg, "reference", "bfloat16", dev, steps=SHORT_STEPS,
                        grad_compress=True)
    truth = train_curve(cfg, "reference", "float32", dev, steps=SHORT_STEPS,
                        grad_compress=True)
    err = held_to_truth("11d", kern, truth["losses"], plain["losses"])
    step_s = statistics.median(kern["step_seconds"][1:])
    base_s = statistics.median(short["uninterrupted"]["step_seconds"][1:])
    log(f"[11d] grad_compress at {cfg.num_layers} layers: residuals "
        f"{kern['ef_bytes'] / 1e9:.3f} GB (4 B a parameter), step "
        f"{step_s:.4f} s against {base_s:.4f} s uncompressed (11c); peak "
        f"device memory {kern['peak_memory_gb']:.2f} GB; launches exact "
        f"{kern['launches']}")
    return {**kern, "plain": plain, "truth": truth, "curve_err": err,
            "step_s": step_s, "uncompressed_step_s": base_s}


def run_leftovers(dev, curves: dict) -> dict:
    """Phase 11: 11a ce_chunk, 11b remat 'dots' and 'none', 11c checkpoint
    and restore, 11d grad_compress."""
    def kept(policy):
        return lambda cfg: expected_kept_launches(cfg, TRAIN_STEPS, policy)

    curves = {**curves, "loss_peak_gb": loss_peak_gb(get_config("llama-1b"),
                                                     dev)}
    out = {"11a": run_lever(dev, "11a", curves,
                            lambda cfg: expected_train_launches(
                                cfg, TRAIN_STEPS), ce_chunk=CE_CHUNK)}
    torch.cuda.empty_cache()
    for policy in ("dots", "none"):
        out[f"11b {policy}"] = run_lever(dev, f"11b {policy}", curves,
                                         kept(policy), remat_policy=policy)
        torch.cuda.empty_cache()
    out["11c"] = run_checkpoint(dev)
    gc.collect()
    torch.cuda.empty_cache()
    out["11d"] = run_compression(dev, out["11c"])
    return out


# ---------------------------------------------------------------------------
# Phase 12: mixtral-8x7b, the mixture of experts at published width
# ---------------------------------------------------------------------------

def throughput_line(tag: str, pre_tok, pre_s, dec_tok, dec_s) -> dict:
    out = {"prefill_tokens_per_s": pre_tok / pre_s,
           "decode_tokens_per_s": dec_tok / dec_s,
           "prefill_s": pre_s, "decode_s": dec_s}
    log(f"[{tag}] prefill {pre_tok} tokens in {pre_s:.4f} s "
        f"({out['prefill_tokens_per_s']:.1f} tok/s); decode {dec_tok} tokens "
        f"in {dec_s:.4f} s ({out['decode_tokens_per_s']:.1f} tok/s)")
    return out


def run_window(dev, m: Models) -> dict:
    """12c: WIN_BATCH requests of WIN_PROMPT tokens (past the 4096-token
    window) and WIN_NEW new tokens each, served by ``Engine(max_len=
    WIN_PROMPT + WIN_NEW + 8)``, whose cache is a ring of the window's
    4096 slots that the prefill already wraps, then by a ``PagedEngine``
    (WIN_PAGES-page tables, CHUNK-token chunks, a pool of WIN_BATCH x
    WIN_PAGES + 1 pages), which keeps every page and lets the kernels mask
    by the window. Each after a warm-up of its route, launches exact; the
    two engines' streams equal, or where one differs the Engine step's
    top-2 logit margin there under the distance between the two routes'
    logits (the ring's decode steps against the paged route's chunks and
    steps in a lone slot), as in phase 10; the Engine route's
    teacher-forced logits within phase 4's bound of the fp32 truth."""
    cfg, params = m.cfg, m.params
    rng = np.random.default_rng(12)
    prompts = rng.integers(0, cfg.vocab_size,
                           (WIN_BATCH, WIN_PROMPT)).astype(np.int32)
    max_len = WIN_PROMPT + WIN_NEW + 8
    engine = Engine(m.kernel, params, max_len=max_len)
    engine.generate(prompts, 2)        # warm-up: the decode graph's capture
    engine.timings.clear()
    kernels.reset_launch_counts()
    served = engine.generate(prompts, WIN_NEW).tokens
    counts = kernels.launch_counts()
    slots = engine._buckets[("decode", WIN_BATCH)].cache["k"].shape[3]
    want = expected_launches(cfg, 1, new_tokens=WIN_NEW)
    log(f"[12c engine] {WIN_BATCH} x {WIN_PROMPT}-token prompts through a "
        f"{slots}-slot ring, {WIN_NEW} new tokens each; launches {counts}")
    if counts != want or slots != cfg.attn_window:
        raise AssertionError(f"[12c engine] launches {counts}, ring of "
                             f"{slots} slots; the path makes {want} over a "
                             f"{cfg.attn_window}-slot ring")
    t = engine.timings[0]
    out = {"12c engine": {"launches": counts, "ring_slots": slots,
                          "throughput": throughput_line(
                              "12c engine", WIN_BATCH * WIN_PROMPT,
                              t["prefill_s"], WIN_BATCH * (WIN_NEW - 1),
                              t["decode_s"])}}

    kw = dict(batch_slots=WIN_BATCH, page_size=PAGE,
              max_pages_per_seq=WIN_PAGES, n_pages=WIN_BATCH * WIN_PAGES + 1,
              chunk_tokens=CHUNK)
    warm = PagedEngine(m.kernel, params, **kw)
    for u in range(2):
        warm.submit(Request(u, np.arange(1, 100 + u, dtype=np.int32), 3))
    warm.run()
    paged = PagedEngine(m.kernel, params, **kw)
    reqs = [Request(u, p, WIN_NEW) for u, p in enumerate(prompts)]
    for r in reqs:
        paged.submit(r)
    kernels.reset_launch_counts()
    results = paged.run()
    counts = kernels.launch_counts()
    rep = paged.report()
    want = expected_paged_launches(cfg, paged)
    log(f"[12c paged] served {len(results)} requests in {rep['steps']} "
        f"steps: {paged.chunks_prefilled} chunks, {rep['decode_steps']} "
        f"decode steps, peak {rep['peak_pages_in_use']} of "
        f"{rep['page_pool_size']} pages; launches {counts}")
    if counts != want:
        raise AssertionError(f"[12c paged] launches {counts}; the engine's "
                             f"counters imply {want}")
    if sorted(results) != [r.uid for r in reqs] or \
            paged.alloc.free_pages != paged.n_pages - 1:
        raise AssertionError(f"[12c paged] completed {sorted(results)}, "
                             f"{paged.alloc.free_pages} pages free")
    for r in reqs:
        check_result(cfg, r, results[r.uid])
        check_result(cfg, r, served[r.uid])
    t = rep["timings"]
    out["12c paged"] = {"launches": counts, "report": rep,
                        "throughput": throughput_line(
                            "12c paged", t["prefill_tokens"], t["prefill_s"],
                            t["decode_tokens"], t["decode_s"])}

    tokens = torch.tensor(served, dtype=torch.int64, device=dev)
    kern, plain, truth, routes = teacher_forced_routed(
        m, m.kernel, params, tokens, WIN_PROMPT, WIN_NEW, max_len)
    greedy = torch.stack([lg.argmax(-1) for lg in kern], dim=1)
    if not torch.equal(greedy, tokens[:, WIN_PROMPT:]):
        raise AssertionError("[12c] the served greedy tokens differ from the "
                             "argmax of the kernel path's teacher-forced "
                             "logits")
    differ = []
    for r in reqs:
        row, other = served[r.uid], results[r.uid]
        if np.array_equal(row, other):
            continue
        pos = int(np.nonzero(row != other)[0][0])
        ring = kern[pos - WIN_PROMPT][r.uid]
        pages = paged_replay(paged, m.kernel, params, row[:pos + 1],
                             WIN_PROMPT, CHUNK, dev, slots=WIN_BATCH,
                             max_pages=WIN_PAGES)[pos - WIN_PROMPT]
        top = torch.topk(ring, 2).values
        margin, dist = (top[0] - top[1]).item(), \
            (ring - pages).abs().max().item()
        log(f"[12c] request {r.uid}: the paged stream first differs from "
            f"the Engine's at position {pos}; the Engine step's top-2 margin "
            f"{margin:.4g}, the routes' logit distance there {dist:.4g}")
        if not margin < dist:
            raise AssertionError(f"[12c] request {r.uid}'s streams differ "
                                 "where the margin exceeds the routes' "
                                 "distance")
        differ.append({"uid": r.uid, "position": pos, "margin": margin,
                       "distance": dist})
    log(f"[12c] {len(reqs) - len(differ)} of {len(reqs)} paged streams equal "
        "the Engine's token for token")
    routing = check_routing("12c", *routes)
    worst, agreement = check_logit_bound("12c", kern, plain, truth)
    log(f"[12c] teacher-forced logits over {len(kern)} steps past the "
        f"window: kernel-path error vs fp32 at most {worst:.3f} of its bound "
        f"(2 x plain bf16 error + 1e-2); greedy agreement with the plain "
        f"bf16 path {agreement:.3f} (information only)")
    out["12c engine"].update(differ=differ, logit_bound_use=worst,
                             greedy_agreement=agreement, routing=routing)
    return out


def run_moe(dev) -> dict:
    """Phase 12: mixtral-8x7b at published width cut to MOE_LAYERS layers,
    weights at a trained model's scale, kernel mode beside the plain bf16
    and fp32 paths: 12a phase 8a's traffic through RequestQueue(Engine)
    and 12b phase 8b's through PagedEngine, with phases 4's and 5's checks
    (launches exact: per layer 2 + 2E fused GEMMs a prefill or chunk and 2E
    a decode step, a replayed decode step bit for bit the eager one, the
    logits under phase 4's bound), then 12c across the window
    (``run_window``). Prints the init time, the peak memory and the
    phase's seconds."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    m = build_models(dev, MOE_ARCH, MOE_LAYERS, trained=True)
    init_s = time.perf_counter() - t0
    out = {"12a": run_slice(dev, m, tag="12a mixtral-8x7b")}
    del out["12a"]["teacher_forced"]
    out["12b"] = run_paged_phase(dev, m, "8b", tag="12b mixtral-8x7b")
    out.update(run_window(dev, m))
    del m
    gc.collect()
    torch.cuda.empty_cache()
    summary = {"init_s": init_s, "seconds": time.perf_counter() - t0,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "decode_tokens_per_s": {
                   p: out[p]["throughput"]["decode_tokens_per_s"]
                   for p in MOE_PHASES},
               "prefill_tokens_per_s": {
                   p: out[p]["throughput"]["prefill_tokens_per_s"]
                   for p in MOE_PHASES}}
    log(f"[12] mixtral-8x7b, {MOE_LAYERS} layers: init {init_s:.1f} s, peak "
        f"memory {summary['peak_memory_gb']:.2f} GB, phase 12 in "
        f"{summary['seconds']:.1f} s; decode tok/s "
        f"{summary['decode_tokens_per_s']}; prefill tok/s "
        f"{summary['prefill_tokens_per_s']}")
    out["12"] = summary
    return out


# ---------------------------------------------------------------------------
# Phase 13: mixtral-8x7b trained at published width
# ---------------------------------------------------------------------------

def expected_moe_train_launches(cfg, steps: int) -> dict:
    """Per layer and step of an MoE block under remat_policy='full': the
    forward's fused GEMMs, q|k and v and each expert's up and down
    (2 + 2E), again in the backward's recompute; for each of them its
    backward's operand pass, dA and dB; the flash forward twice and the
    flash backward's two launches (the main kernel and the dq
    conversion)."""
    n = cfg.num_layers * steps
    g = 2 + 2 * cfg.moe.num_experts
    return {**no_launches(), "gemm_fused": 2 * g * n,
            "flash_attention_fwd": 2 * n, "gemm_bwd_g": g * n,
            "gemm_bwd_da": g * n, "gemm_bwd_db": g * n,
            "flash_attention_bwd": 2 * n}


def moe_train_cfg():
    return dataclasses.replace(get_config(MOE_ARCH),
                               num_layers=MOE_TRAIN_LAYERS)


def run_moe_grad_check(dev) -> dict:
    """Phase 13a: per-leaf grads of lm_loss, its load-balancing term
    included, at mixtral-8x7b's published width cut to MOE_TRAIN_LAYERS,
    weights at a trained model's scale: kernel mode against the fp32 truth
    within 2x the plain bf16 path's distance + 1e-3 (phase 6a's bound), the
    plain paths routed as the kernel path (``routed``: its forward and the
    recompute's choices replayed in order); the fp32 router's
    disagreement share through ``check_routing``."""
    cfg = moe_train_cfg()
    batch = next(train_data(cfg, dev))
    route, flips = [], []

    def grads(mode, dtype, ctx):
        model = build_model(dataclasses.replace(cfg, compute_dtype=dtype),
                            mode=mode, device=dev)
        params = tree_map(lambda t: t.requires_grad_(), trained_scale(
            model, model.init(seed=0, dtype=cfg.param_dtype)))
        kernels.reset_launch_counts()
        with ctx:
            loss, metrics, g = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        named = {path: x.float() for (path, _), x
                 in zip(named_leaves(params), g)}
        return (float(loss), float(metrics["aux"]), named,
                kernels.launch_counts())

    t0 = time.perf_counter()
    k_loss, k_aux, kern, counts = grads("kernel", "bfloat16",
                                        routed(record=route))
    want = expected_moe_train_launches(cfg, 1)
    if counts != want:
        raise AssertionError(f"[13a] launches {counts}; one step of "
                             f"{cfg.num_layers} MoE layers makes {want}")
    p_loss, p_aux, plain, _ = grads("reference", "bfloat16",
                                    routed(replay=route))
    t_loss, t_aux, truth, _ = grads("reference", "float32",
                                    routed(replay=route, flips=flips))
    routing = check_routing("13a", route, flips)
    worst, per_leaf = 0.0, {}
    for path, t_ in truth.items():
        k_, p_ = kern[path], plain[path]
        k_err = (k_ - t_).abs().max().item()
        p_err = (p_ - t_).abs().max().item()
        per_leaf[path] = {"kernel_err": k_err, "plain_err": p_err,
                          "truth_max": t_.abs().max().item()}
        if not k_err <= 2.0 * p_err + 1e-3:
            raise AssertionError(f"[13a] {path}: kernel-mode grad {k_err:.4g} "
                                 f"from fp32, plain bf16 {p_err:.4g}")
        worst = max(worst, k_err / (2.0 * p_err + 1e-3))
    del kern, plain, truth
    log(f"[13a] {MOE_ARCH} at published width, {cfg.num_layers} layer(s), "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, weights at std "
        f"fan_in^-1/2, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: loss (aux) kernel "
        f"{k_loss:.5f} ({k_aux:.5f}), plain bf16 {p_loss:.5f} ({p_aux:.5f}), "
        f"fp32 {t_loss:.5f} ({t_aux:.5f}); every one of {len(per_leaf)} "
        f"leaves' kernel-mode grad error within its bound (2 x plain bf16 "
        f"error + 1e-3), at most {worst:.3f} of it; launches {counts}; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"losses": {"kernel": k_loss, "plain": p_loss, "truth": t_loss},
            "aux": {"kernel": k_aux, "plain": p_aux, "truth": t_aux},
            "launches": counts, "bound_use": worst, "routing": routing,
            "leaves": per_leaf}


def run_moe_training(dev) -> dict:
    """Phase 13b: MOE_TRAIN_STEPS steps of train_loop at 13a's config in
    kernel mode (launches exact), then the plain bf16 and fp32 curves of
    the same steps; the step time (median after the first), tokens/s, the
    peak memory and one traced step's busy share."""
    cfg = moe_train_cfg()
    t0 = time.perf_counter()
    kern = train_curve(cfg, "kernel", "bfloat16", dev, steps=MOE_TRAIN_STEPS,
                       trained=True)
    want = expected_moe_train_launches(cfg, MOE_TRAIN_STEPS)
    losses = kern["losses"]
    step_s = statistics.median(kern["step_seconds"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[13b] {MOE_ARCH}, {cfg.num_layers} layer(s), remat "
        f"{cfg.remat_policy!r}, {MOE_TRAIN_STEPS} steps of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens in kernel mode: losses "
        f"{[round(x, 4) for x in losses]}; launches {kern['launches']}")
    if kern["launches"] != want:
        raise AssertionError(f"[13b] launches {kern['launches']}; "
                             f"{MOE_TRAIN_STEPS} steps of the model make "
                             f"{want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[13b] losses {losses}: not finite and falling")
    log(f"[13b] step time {step_s:.4f} s (median of the steps after the "
        f"first; step seconds {[round(x, 4) for x in kern['step_seconds']]}"
        f"), {tokens / step_s:.1f} tokens/s; peak device memory "
        f"{kern['peak_memory_gb']:.2f} GB")
    plain = train_curve(cfg, "reference", "bfloat16", dev,
                        steps=MOE_TRAIN_STEPS, trained=True)
    truth = train_curve(cfg, "reference", "float32", dev,
                        steps=MOE_TRAIN_STEPS, trained=True)
    k_err = float(np.abs(np.subtract(losses, truth["losses"])).max())
    p_err = float(np.abs(np.subtract(plain["losses"], truth["losses"])).max())
    log(f"[13b] plain bf16 losses {[round(x, 4) for x in plain['losses']]} "
        f"(median step {statistics.median(plain['step_seconds'][1:]):.4f} s, "
        f"peak {plain['peak_memory_gb']:.2f} GB); fp32 "
        f"{[round(x, 4) for x in truth['losses']]}; the kernel curve is "
        f"{k_err:.4g} from fp32, the plain bf16 curve {p_err:.4g} (bound "
        f"2.5 x {p_err:.4g} + 0.05)")
    if not k_err <= 2.5 * p_err + 0.05:
        raise AssertionError(f"[13b] kernel curve {k_err:.4g} from the fp32 "
                             f"truth, plain bf16 {p_err:.4g}")
    torch.cuda.reset_peak_memory_stats()
    prof = profile_step(build_model(cfg, mode="kernel", device=dev),
                        TRAIN_BATCH, TRAIN_SEQ, warmup=1)
    tr = prof["traced"]
    log(f"[13b] one traced step: device busy {tr['device_busy_ms']:.1f} of "
        f"{tr['traced_wall_ms']:.1f} ms ({tr['device_busy_share']:.3f}); "
        f"device ms by family "
        f"{ {k: round(v, 2) for k, v in tr['device_ms_by_family'].items()} }"
        f"; untraced step {prof['step_s']:.4f} s; phase 13b in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"launches": kern["launches"], "kernel": kern, "plain": plain,
            "truth": truth, "curve_err": {"kernel": k_err, "plain": p_err},
            "step_s": step_s, "tokens_per_s": tokens / step_s,
            "peak_memory_gb": kern["peak_memory_gb"], "profile": prof}


# ---------------------------------------------------------------------------
# Phase 14: telemetry
# ---------------------------------------------------------------------------

def check_journal(tag, cap, launches, replayed) -> dict:
    """Every kernel's journal events (``kernels.journal_counts``) equal its
    launch count less the launches CUDA graph replays added; every event of
    a timed capture carries its wall time. Returns the events by kernel."""
    events = kernels.journal_counts(cap)
    want = {k: launches[k] - replayed[k] for k in launches}
    if events != want:
        raise AssertionError(f"[{tag}] journal events {events}; launches "
                             f"{launches} less replayed {replayed} are "
                             f"{want}")
    if cap.timing and not all(e.wall_s and e.wall_s > 0
                              for e in cap.launches):
        raise AssertionError(f"[{tag}] a timed capture's event has no wall "
                             "time")
    return events


def trace_check(tag, caps: dict, out_dir=None) -> dict:
    """Export each capture's Chrome trace and counters (TRACE_<key>.json,
    COUNTERS_<key>.json) into ``out_dir`` (else a temporary directory,
    removed after) and run ``tools/trace_check.py`` on them as a
    subprocess; raises unless it passes. Returns the files' sizes."""
    tmp = out_dir is None
    where = tempfile.mkdtemp() if tmp else out_dir
    os.makedirs(where, exist_ok=True)
    try:
        sizes = {}
        for key, cap in caps.items():
            for path in (obs.export_chrome_trace(
                    cap, os.path.join(where, f"TRACE_{key}.json")),
                    obs.export_counters(
                        cap, os.path.join(where, f"COUNTERS_{key}.json"))):
                sizes[os.path.basename(path)] = os.path.getsize(path)
        tool = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tools", "trace_check.py")
        res = subprocess.run([sys.executable, tool, where],
                             capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            raise AssertionError(f"[{tag}] tools/trace_check.py failed "
                                 f"({res.returncode}): {res.stderr[-2000:]}")
        log(f"[{tag}] {res.stdout.strip()}; files {sizes}")
        return sizes
    finally:
        if tmp:
            shutil.rmtree(where, ignore_errors=True)


def captured_runs(run, label: str, rounds: int = 2) -> dict:
    """``run()`` (-> (seconds, result)) once to warm up, then ``rounds``
    rounds of: without a capture, under ``obs.capture(timing=True)``, under
    an untimed capture; each from zeroed launch counts. Returns {kind:
    [seconds]} for "plain", "timed" and "untimed", "last": the last timed
    run's (seconds, result, recorder, launches, replayed), and "cost_s"
    each capture's mean seconds less the uncaptured mean."""
    run()
    out = {"plain": [], "timed": [], "untimed": []}
    for _ in range(rounds):
        for kind in ("plain", "timed", "untimed"):
            ctx = (obs.capture(timing=True) if kind == "timed"
                   else obs.capture() if kind == "untimed"
                   else contextlib.nullcontext())
            kernels.reset_launch_counts()
            with ctx as cap:
                sec, result = run()
            torch.cuda.synchronize()
            out[kind].append(sec)
            if kind == "timed":
                out["last"] = (sec, result, cap, kernels.launch_counts(),
                               kernels.replayed_launch_counts())
    base = statistics.mean(out["plain"])
    out["cost_s"] = {"timed": statistics.mean(out["timed"]) - base,
                     "untimed": statistics.mean(out["untimed"]) - base,
                     "plain": base}
    log(f"[14] {label}, seconds in turns: without a capture "
        f"{[round(x, 4) for x in out['plain']]}, under a timed capture "
        f"{[round(x, 4) for x in out['timed']]}, an untimed one "
        f"{[round(x, 4) for x in out['untimed']]}")
    return out


def backward_thread_turns(run, rounds: int = 2) -> dict:
    """``run()`` (-> (seconds, result)) without a capture, the backward on
    autograd's device thread (``train.trainer._grad`` swapped for a bare
    ``torch.autograd.grad``) and on the calling thread as ``_grad`` runs
    it, in turns (device, calling, calling, device) ``rounds`` times:
    {"device": [seconds], "calling": [seconds]}."""
    out = {"device": [], "calling": []}
    for kind in ("device", "calling", "calling", "device") * rounds:
        ctx = (mock.patch.object(trainer_mod, "_grad",
                                 lambda loss, wrt: torch.autograd.grad(
                                     loss, wrt))
               if kind == "device" else contextlib.nullcontext())
        with ctx:
            out[kind].append(run()[0])
    log(f"[14] 6b training step, seconds in turns without a capture: the "
        f"backward on autograd's device thread "
        f"{[round(x, 4) for x in out['device']]} (median "
        f"{statistics.median(out['device']):.4f}), on the calling thread "
        f"{[round(x, 4) for x in out['calling']]} (median "
        f"{statistics.median(out['calling']):.4f})")
    return out


def run_telemetry(dev, out_dir=None) -> dict:
    """Phase 14: llama-1b in kernel mode, 5a's serving pass (a fresh
    PagedEngine each run, so each captures its own decode graphs) and one
    6b training step (``train_loop``), each through ``captured_runs``; the
    last timed capture's journal held to the launch counts
    (``check_journal``), its counters to the engine's attributes and the
    trainer's steps, its exports through ``trace_check``; the step with
    the backward on autograd's device thread against the calling thread
    (``backward_thread_turns``)."""
    t_phase = time.perf_counter()
    cfg = get_config("llama-1b")
    model = build_model(cfg, mode="kernel", device=dev)
    params = model.init(seed=0)
    kw = dict(batch_slots=SLOTS, page_size=PAGE, max_pages_per_seq=MAX_PAGES,
              **PHASES["5a"])
    def serve():
        engine = PagedEngine(model, params, **kw)
        for r in paged_requests(cfg, "5a"):
            engine.submit(r)
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, engine

    runs = captured_runs(serve, "5a serving pass")
    _, engine, cap, launches, replayed = runs["last"]
    events = check_journal("14 serve", cap, launches, replayed)
    rep = engine.report()
    attrs = {"engine.admissions": engine.admissions,
             "engine.tokens_generated": engine.tokens_generated,
             "engine.preemptions": engine.preemptions,
             "engine.peak_pages_in_use": engine.peak_pages_in_use,
             **{f"engine.bucket_lru.{k}": v
                for k, v in rep["bucket_lru"].items()}}
    got = {k: cap.counter(k) for k in attrs}
    spans = {n: sum(1 for s in cap.spans if s.name == n)
             for n in ("engine.run", "engine.prefill", "engine.decode_step")}
    if got != attrs or spans != {"engine.run": 1,
                                 "engine.prefill": engine.prefills,
                                 "engine.decode_step": engine.decode_steps}:
        raise AssertionError(f"[14 serve] counters {got}, spans {spans}; the "
                             f"engine's {attrs}, {engine.prefills} prefills, "
                             f"{engine.decode_steps} decode steps")
    serve_summary = cap.summary()
    log(f"[14 serve] journal events {events}: the launches less the "
        f"replayed {replayed}; counters equal the engine's attributes; "
        f"spans {spans}; summary {json.dumps(serve_summary)}")
    serve = {"launches": launches, "replayed": replayed, "events": events,
             "summary": serve_summary, "capture_cost_s": runs["cost_s"]}
    serve_cap = cap
    del runs, engine

    data = train_data(cfg, dev)
    opt = AdamWConfig(schedule=cosine_schedule(TRAIN_LR, 2, TRAIN_STEPS))

    def train():
        res = train_loop(model, data, 1, opt, seed=0, log_every=0)
        sec = res.step_seconds[0]
        del res
        return sec, None

    runs = captured_runs(train, "6b training step")
    _, _, cap, launches, replayed = runs["last"]
    events = check_journal("14 train", cap, launches, replayed)
    want = expected_train_launches(cfg, 1)
    steps = [s for s in cap.spans if s.name == "trainer.step"]
    if launches != want or cap.counter("trainer.steps") != 1 \
            or len(steps) != 1:
        raise AssertionError(f"[14 train] launches {launches} (want {want}), "
                             f"trainer.steps {cap.counter('trainer.steps')}, "
                             f"{len(steps)} trainer.step spans")
    train_summary = cap.summary()
    log(f"[14 train] journal events {events} equal the launches; "
        f"trainer.steps 1, one trainer.step span of {steps[0].dur:.4f} s; "
        f"summary {json.dumps(train_summary)}")
    sizes = trace_check("14", {"serve": serve_cap, "train": cap}, out_dir)
    threads = backward_thread_turns(train)
    train = {"launches": launches, "events": events,
             "summary": train_summary, "capture_cost_s": runs["cost_s"],
             "backward_thread_s": threads}
    del runs, model, params, data
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[14] capture cost (timed, untimed) over the run without one: "
        f"serving {serve['capture_cost_s']['timed']:.4f} s, "
        f"{serve['capture_cost_s']['untimed']:.4f} s of "
        f"{serve['capture_cost_s']['plain']:.4f} s; training step "
        f"{train['capture_cost_s']['timed']:.4f} s, "
        f"{train['capture_cost_s']['untimed']:.4f} s of "
        f"{train['capture_cost_s']['plain']:.4f} s; phase 14 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"14 serve": serve, "14 train": train, "14 trace_files": sizes}


# ---------------------------------------------------------------------------
# Phase 15: recurrentgemma-2b, RG-LRU and local-attention blocks, served
# ---------------------------------------------------------------------------

def expected_rg_launches(cfg, prefills: int, steps: int, decode: str) -> dict:
    """What a hybrid stack's prefills (a batch's, or one sequence's) and
    decode steps launch, by block kind: an 'rg' block's MLP, the geglu up
    and the down (2 ``gemm_fused``), in each; a 'local' block's q|k and v
    GEMMs (rung 2: head_dim 256), its MLP's, one flash forward and two
    RoPE launches (q and k) in a prefill, its MLP's and one ``decode``
    kernel in a step. The recurrence is plain torch, as the reference's."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    n_rg, n_local = kinds.count("rg"), kinds.count("local")
    return {**no_launches(),
            "gemm_fused": prefills * (2 * n_rg + 4 * n_local)
            + steps * 2 * (n_rg + n_local),
            "flash_attention_fwd": prefills * n_local,
            "rope": prefills * 2 * n_local, decode: steps * n_local}


def run_rg_engine(dev, m: Models) -> dict:
    """15b: RG_REQUESTS requests of 2100-2304 tokens (past the 2048-token
    local window), RG_NEW new tokens each, through ``serve_queue`` at batch
    RG_BATCH (left-padded to RG_PROMPT, as the reference's): launches exact
    by block kind, rings of the window's slots, the served streams' greedy
    tokens the argmax of the kernel path's teacher-forced logits, whose
    prefill and first decode step lie within phase 4's bound of the fp32
    truth."""
    cfg, params = m.cfg, m.params
    rng = np.random.default_rng(15)
    warm = rng.integers(0, cfg.vocab_size, (RG_BATCH, RG_PROMPT))
    prompts = [rng.integers(0, cfg.vocab_size,
                            int(rng.integers(RG_SHORTEST, RG_PROMPT + 1)))
               .astype(np.int32) for _ in range(RG_REQUESTS)]
    reqs, _, rows, engine, counts, throughput = serve_queue(
        "15b", m, prompts, (RG_PROMPT,), RG_NEW, warm, RG_BATCH)
    batches = RG_REQUESTS // RG_BATCH
    want = expected_rg_launches(cfg, batches, batches * (RG_NEW - 1),
                                "flash_decode")
    entry = engine._buckets[("decode", RG_BATCH)]
    slots = {c["k"].shape[2] for c in entry.cache.values() if "k" in c}
    log(f"[15b] served {len(reqs)} requests through {cfg.num_layers} layers "
        f"({[cfg.layer_kind(i) for i in range(3)]} cycled), local rings of "
        f"{slots} slots; launches {counts}")
    if counts != want or slots != {cfg.rglru.local_window}:
        raise AssertionError(f"[15b] launches {counts}, rings {slots}; the "
                             f"path makes {want}")
    tokens = torch.tensor(rows[0], dtype=torch.int64, device=dev)
    args = (tokens[:, :RG_PROMPT + 2], RG_PROMPT, 2, engine.max_len)
    kern = teacher_forced_logits(m.kernel, params, *args)
    plain = teacher_forced_logits(m.plain, params, *args)
    truth = teacher_forced_logits(m.truth, m.params32, *args)
    greedy = torch.stack([lg.argmax(-1) for lg in kern], dim=1)
    if not torch.equal(greedy, tokens[:, RG_PROMPT:RG_PROMPT + 2]):
        raise AssertionError("[15b] the served greedy tokens differ from the "
                             "argmax of the kernel path's teacher-forced "
                             "logits")
    worst, agreement = check_logit_bound("15b", kern, plain, truth)
    err = [(k - t_).abs().max().item() for k, t_ in zip(kern, truth)]
    p_err = [(p - t_).abs().max().item() for p, t_ in zip(plain, truth)]
    log(f"[15b] prefill and first decode logits: kernel path {err} from "
        f"fp32, plain bf16 {p_err}; at most {worst:.3f} of the bound (2 x "
        f"plain bf16 + 1e-2); greedy agreement with the plain bf16 path "
        f"{agreement:.3f} (information only)")
    return {"served": len(reqs), "launches": counts,
            "throughput": throughput, "bucket_lru": dict(engine.lru_stats),
            "logit_bound_use": worst,
            "logit_err": {"kernel": err, "plain": p_err},
            "greedy_agreement": agreement}


def run_rg_paged(dev, m: Models) -> dict:
    """15c: PagedEngine's three refusals on a recurrent stack
    (``check_refusals``), then RG_PAGED requests of 200-2300 tokens, none a
    page multiple (exact-length prefills writing each slot's recurrent
    state), RG_NEW new tokens each, SLOTS slots of RG_PAGES 64-token pages
    (``serve_paged``: launches exact by block kind, a replayed step bit for
    bit the eager one); each stream against ``Engine.generate`` of its
    prompt alone by ``against_engine``; decode tokens/s."""
    cfg = m.cfg
    kw = dict(batch_slots=SLOTS, page_size=PAGE, max_pages_per_seq=RG_PAGES)
    refusals = check_refusals("15c", m, kw)
    rng = np.random.default_rng(16)
    lens = [int(n) + (int(n) % PAGE == 0) for n in
            rng.integers(RG_PAGED_LENS[0], RG_PAGED_LENS[1] + 1, RG_PAGED)]
    reqs = [Request(u, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    RG_NEW) for u, n in enumerate(lens)]
    engine, results, rep, counts, reprefills, throughput = serve_paged(
        "15c", m, reqs, kw, lambda c, e: expected_rg_launches(
            c, e.prefills, e.decode_steps, "flash_decode_paged"))
    fixed = Engine(m.kernel, m.params, max_len=max(lens) + RG_NEW + 8)
    differ = []
    for r in reqs:
        want = fixed.generate(r.prompt[None, :], RG_NEW).tokens[0]
        d = against_engine("15c", m, r.uid, want, results[r.uid], want[None],
                           0, len(r.prompt), fixed.max_len, engine,
                           reprefills.get(r.uid, ()), RG_PAGES)
        differ += [d] if d else []
    log(f"[15c] {len(reqs) - len(differ)} of {len(reqs)} paged streams equal "
        "the Engine's (each prompt alone) token for token")
    return {"report": rep, "launches": counts, "throughput": throughput,
            "refusals": refusals, "differ": differ}


def run_recurrentgemma(dev) -> dict:
    """Phase 15: recurrentgemma-2b at published width and all 26 layers
    (the pattern ('rg', 'rg', 'local') cycled: 18 RG-LRU blocks, 8 local
    attention blocks in a 2048-token window, head_dim 256, MQA), seeded
    random weights with the tied embedding at a trained model's scale,
    kernel mode beside the plain bf16 and fp32 paths: 15b through
    ``RequestQueue(Engine)``, 15c through ``PagedEngine``. (15a, the
    kernels at its shapes, runs with phase 3.) Prints the init time, the
    peak memory and the phase's seconds."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    m = build_models(dev, RG_ARCH, trained=True)
    init_s = time.perf_counter() - t0
    out = {"15b": run_rg_engine(dev, m)}
    gc.collect()
    torch.cuda.empty_cache()
    out["15c"] = run_rg_paged(dev, m)
    del m
    gc.collect()
    torch.cuda.empty_cache()
    out["15"] = {"init_s": init_s, "seconds": time.perf_counter() - t0,
                 "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[15] {RG_ARCH}, {get_config(RG_ARCH).num_layers} layers: init "
        f"{init_s:.1f} s, peak memory "
        f"{out['15']['peak_memory_gb']:.2f} GB, phase 15 in "
        f"{out['15']['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 16: recurrentgemma-2b trained
# ---------------------------------------------------------------------------

def rg_train_cfg():
    return dataclasses.replace(get_config(RG_ARCH), num_layers=RG_TRAIN_LAYERS)


def expected_rg_train_launches(cfg, steps: int) -> dict:
    """Per layer and step of the hybrid stack under remat_policy='full', by
    block kind: an 'rg' block's 2 fused GEMMs (the geglu up and the down),
    a 'local' block's 4 (rung 2 at head_dim 256: q|k and v on the norm
    prologue, then the MLP's), each again in the backward's recompute and
    each with its backward's operand pass, dA and dB; a 'local' block's
    flash forward twice, the flash backward's two launches (the main
    kernel and the dq conversion), and 6 RoPE launches (q and k in the
    forward, in the recompute and in the backward). The recurrence is
    plain torch."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    n_rg, n_local = kinds.count("rg") * steps, kinds.count("local") * steps
    g = 2 * n_rg + 4 * n_local
    return {**no_launches(), "gemm_fused": 2 * g, "gemm_bwd_g": g,
            "gemm_bwd_da": g, "gemm_bwd_db": g,
            "flash_attention_fwd": 2 * n_local,
            "flash_attention_bwd": 2 * n_local, "rope": 6 * n_local}


def grad_check(dev, tag: str, cfg, batch_size: int, seq: int,
               want: dict) -> dict:
    """Per-leaf grads of ``Model.loss`` at ``cfg``, one batch of
    ``batch_size`` x ``seq`` tokens (``train_data``), weights at a trained
    model's scale: kernel mode against the fp32 truth within 2x the plain
    bf16 path's distance + 1e-3 (phase 6a's bound), or, where the path
    launches no kernel (``want`` is ``no_launches()``: the kernel path is
    the plain bf16 path), within PLAIN_GRAD_SHARE of the fp32 leaf's
    largest entry; the kernel run's launches equal to ``want``."""
    batch = next(train_data(cfg, dev, batch_size, seq))

    def grads(mode, dtype):
        model = build_model(dataclasses.replace(cfg, compute_dtype=dtype),
                            mode=mode, device=dev)
        params = tree_map(lambda t: t.requires_grad_(), trained_scale(
            model, model.init(seed=0, dtype=cfg.param_dtype)))
        kernels.reset_launch_counts()
        loss, _, g = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        named = {path: x.float() for (path, _), x
                 in zip(named_leaves(params), g)}
        return float(loss), named, kernels.launch_counts()

    t0 = time.perf_counter()
    k_loss, kern, counts = grads("kernel", "bfloat16")
    if counts != want:
        raise AssertionError(f"[{tag}] launches {counts}; one step of "
                             f"{cfg.num_layers} layers makes {want}")
    plain_path = want == no_launches()
    p_loss, plain = ((k_loss, kern) if plain_path
                     else grads("reference", "bfloat16")[:2])
    t_loss, truth, _ = grads("reference", "float32")
    worst, per_leaf = 0.0, {}
    for path, t_ in truth.items():
        k_err = (kern[path] - t_).abs().max().item()
        t_max = t_.abs().max().item()
        p_err = None if plain_path else (plain[path] - t_).abs().max().item()
        bound = PLAIN_GRAD_SHARE * t_max if plain_path else 2.0 * p_err + 1e-3
        per_leaf[path] = {"kernel_err": k_err, "plain_err": p_err,
                          "truth_max": t_max, "bound": bound}
        if not k_err <= bound:
            raise AssertionError(f"[{tag}] {path}: kernel-mode grad "
                                 f"{k_err:.4g} from fp32, bound {bound:.4g}")
        worst = max(worst, k_err / bound)
    del kern, plain, truth
    kinds = sorted({cfg.layer_kind(i) for i in range(cfg.num_layers)})
    rule = (f"{PLAIN_GRAD_SHARE} x the fp32 leaf's largest entry: no kernel "
            "runs, the kernel path is the plain bf16 path" if plain_path
            else "2 x plain bf16 error + 1e-3")
    log(f"[{tag}] {cfg.name} at published width, {cfg.num_layers} layers "
        f"({kinds} blocks), weights at std fan_in^-1/2, {batch_size} x "
        f"{seq} tokens: loss kernel {k_loss:.5f}, plain bf16 {p_loss:.5f}, "
        f"fp32 {t_loss:.5f}; every one of {len(per_leaf)} leaves' "
        f"kernel-mode grad error within its bound ({rule}), at most "
        f"{worst:.3f} of it; launches {counts}; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"losses": {"kernel": k_loss, "plain": p_loss, "truth": t_loss},
            "launches": counts, "bound_use": worst, "leaves": per_leaf}


def run_rg_grad_check(dev) -> dict:
    """Phase 16b: per-leaf grads of lm_loss at recurrentgemma-2b's
    published width cut to RG_TRAIN_LAYERS layers, one batch of
    RG_TRAIN_BATCH x RG_TRAIN_SEQ tokens (``grad_check``)."""
    cfg = rg_train_cfg()
    return grad_check(dev, "16b", cfg, RG_TRAIN_BATCH, RG_TRAIN_SEQ,
                      expected_rg_train_launches(cfg, 1))


def training_run(dev, tag: str, cfg, batch_size: int, seq: int,
                 want: dict) -> dict:
    """TRAIN_STEPS steps of train_loop at ``cfg`` in kernel mode from
    weights at a trained model's scale, ``batch_size`` x ``seq`` tokens a
    step: launches equal to ``want``, every loss finite and the last below
    the first; the plain bf16 and fp32 curves of the same steps, the kernel
    curve within 2.5x the plain bf16 curve's distance from fp32 + 0.05, or,
    where the path launches no kernel (the kernel curve is the plain bf16
    curve, not run twice), within PLAIN_CURVE_BOUND of fp32. The step time
    (median after the first), tokens/s, the peak memory and one traced
    step's busy share and device ms by kernel family."""
    t0 = time.perf_counter()
    shape = dict(trained=True, batch=batch_size, seq=seq)
    kern = train_curve(cfg, "kernel", "bfloat16", dev, **shape)
    losses = kern["losses"]
    step_s = statistics.median(kern["step_seconds"][1:])
    tokens = batch_size * seq
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    log(f"[{tag}] {cfg.name}, {cfg.num_layers} layers "
        f"({ {k: kinds.count(k) for k in sorted(set(kinds))} }), remat "
        f"{cfg.remat_policy!r}, {TRAIN_STEPS} steps of {batch_size} x "
        f"{seq} tokens in kernel mode: losses "
        f"{[round(x, 4) for x in losses]}; launches {kern['launches']}")
    if kern["launches"] != want:
        raise AssertionError(f"[{tag}] launches {kern['launches']}; "
                             f"{TRAIN_STEPS} steps of the model make {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] losses {losses}: not finite and "
                             "falling")
    log(f"[{tag}] step time {step_s:.4f} s (median of the steps after the "
        f"first; step seconds {[round(x, 4) for x in kern['step_seconds']]}"
        f"), {tokens / step_s:.1f} tokens/s; peak device memory "
        f"{kern['peak_memory_gb']:.2f} GB")
    out = {"launches": kern["launches"], "kernel": kern, "step_s": step_s,
           "tokens_per_s": tokens / step_s,
           "peak_memory_gb": kern["peak_memory_gb"]}
    plain_path = want == no_launches()
    plain = (None if plain_path
             else train_curve(cfg, "reference", "bfloat16", dev, **shape))
    truth = train_curve(cfg, "reference", "float32", dev, **shape)
    k_err = float(np.abs(np.subtract(losses, truth["losses"])).max())
    if plain_path:
        p_err, bound = None, PLAIN_CURVE_BOUND
        seen = ("no kernel runs: the kernel curve is the plain bf16 curve; "
                f"bound {bound}")
    else:
        p_err = float(np.abs(np.subtract(plain["losses"],
                                         truth["losses"])).max())
        bound = 2.5 * p_err + 0.05
        seen = (f"plain bf16 losses {[round(x, 4) for x in plain['losses']]}"
                f" (median step "
                f"{statistics.median(plain['step_seconds'][1:]):.4f} s, peak "
                f"{plain['peak_memory_gb']:.2f} GB), {p_err:.4g} from fp32; "
                f"bound 2.5 x {p_err:.4g} + 0.05")
    log(f"[{tag}] fp32 losses {[round(x, 4) for x in truth['losses']]} "
        f"(peak {truth['peak_memory_gb']:.2f} GB); the kernel curve is "
        f"{k_err:.4g} from fp32; {seen}")
    if not k_err <= bound:
        raise AssertionError(f"[{tag}] kernel curve {k_err:.4g} from the "
                             f"fp32 truth, bound {bound:.4g}")
    out.update(plain=plain, truth=truth,
               curve_err={"kernel": k_err, "plain": p_err, "bound": bound})
    torch.cuda.reset_peak_memory_stats()
    prof = profile_step(build_model(cfg, mode="kernel", device=dev),
                        batch_size, seq, warmup=1)
    tr = prof["traced"]
    log(f"[{tag}] one traced step: device busy {tr['device_busy_ms']:.1f} "
        f"of {tr['traced_wall_ms']:.1f} ms ({tr['device_busy_share']:.3f}); "
        f"device ms by family "
        f"{ {k: round(v, 2) for k, v in tr['device_ms_by_family'].items()} }"
        f"; untraced step {prof['step_s']:.4f} s; phase {tag} in "
        f"{time.perf_counter() - t0:.1f} s")
    out["profile"] = prof
    return out


def run_rg_training(dev) -> dict:
    """Phase 16c: ``training_run`` at 16b's config, launches exact by block
    kind (``expected_rg_train_launches``)."""
    cfg = rg_train_cfg()
    return training_run(dev, "16c", cfg, RG_TRAIN_BATCH, RG_TRAIN_SEQ,
                        expected_rg_train_launches(cfg, TRAIN_STEPS))


# ---------------------------------------------------------------------------
# Phases 17-19: mamba2-130m served and trained, internvl2-2b
# ---------------------------------------------------------------------------

def cache_bytes(cache) -> int:
    return sum(nbytes(x) for _, x in named_leaves(cache))


def first_diff(a, b):
    """The first position where two token rows differ, or None."""
    ne = np.nonzero(np.asarray(a) != np.asarray(b))[0]
    return int(ne[0]) if len(ne) else None


def against_engine(tag, m, uid, want, got, batch_rows, row: int, plen: int,
                   max_len: int, engine, reprefills=(),
                   max_pages: int = MAX_PAGES):
    """A paged stream ``got`` against the Engine's ``want`` for the same
    prompt (``row`` of the Engine batch ``batch_rows``, unpadded prompts of
    ``plen`` tokens): equal, or first apart at a position where the Engine
    step's top-2 logit margin is under the two routes' logit distance there
    (phase 10's rule). The Engine route is the batch teacher-forced through
    prefill and decode steps, the paged route a lone-slot replay from the
    last exact-length prefill before that position: the prompt's, or a
    preemption's re-prefill (``reprefills``: the continuation's lengths).
    Returns None, or the divergence."""
    pos = first_diff(want, got)
    if pos is None:
        return None
    dev = m.params["embed"].device
    forced = torch.tensor(batch_rows[:, :pos + 1], dtype=torch.int64,
                          device=dev)
    ring = teacher_forced_logits(m.kernel, m.params, forced, plen,
                                 pos + 1 - plen, max_len)[-1][row]
    start = max([plen] + [n for n in reprefills if n <= pos])
    pages = paged_replay(engine, m.kernel, m.params, want[:pos + 1], start,
                         None, dev, slots=SLOTS,
                         max_pages=max_pages)[pos - start]
    top = torch.topk(ring, 2).values
    margin = (top[0] - top[1]).item()
    dist = (ring - pages).abs().max().item()
    log(f"[{tag}] request {uid}: the paged stream first differs from the "
        f"Engine's at position {pos} (route from an exact prefill of "
        f"{start} tokens); the Engine step's top-2 margin {margin:.4g}, the "
        f"routes' logit distance there {dist:.4g}")
    if not margin < dist:
        raise AssertionError(f"[{tag}] request {uid}'s streams differ where "
                             "the margin exceeds the routes' distance")
    return {"uid": uid, "position": pos, "margin": margin, "distance": dist,
            "route_start": start}


def serve_queue(tag, m, prompts, buckets, new: int, warm, batch: int = 4):
    """``prompts`` through ``RequestQueue(Engine)`` at ``batch``, each
    left-padded to the least of ``buckets`` that holds it, ``new`` new
    tokens each, after the warm-up batch ``warm``: every request served, a
    replayed decode step bit for bit the eager one, the results, prefill
    and decode tokens/s. Returns (requests, results, each batch's token
    rows as served, left-padded, the Engine, launch counts, throughput)."""
    cfg, params = m.cfg, m.params
    engine = Engine(m.kernel, params, max_len=max(buckets) + new + 8)
    engine.generate(warm, 2)
    engine.timings.clear()
    queue = RequestQueue(engine, batch_size=batch, buckets=tuple(buckets))
    reqs = [Request(u, p, new) for u, p in enumerate(prompts)]
    for r in reqs:
        queue.submit(r)
    kernels.reset_launch_counts()
    served = queue.flush(force=True)
    counts = kernels.launch_counts()
    if served != len(reqs):
        raise AssertionError(f"[{tag}] served {served} of {len(reqs)}")
    entry = engine._buckets[("decode", batch)]
    token = torch.arange(batch, device=params["embed"].device)[:, None] * 7 + 1
    pos = max(buckets) + 3

    def eager(cache):
        return m.kernel.decode_step(params, token, cache, pos)[1]
    check_graph_replay(tag, entry, entry.cache, dict(token=token, pos=pos),
                       eager)
    for r in reqs:
        check_result(cfg, r, queue.results[r.uid])
    t = engine.timings
    throughput = throughput_line(
        tag, sum(x["batch"] * x["prompt_len"] for x in t),
        sum(x["prefill_s"] for x in t),
        sum(x["batch"] * (x["new_tokens"] - 1) for x in t),
        sum(x["decode_s"] for x in t))

    def padded(r):
        bucket = min(b for b in buckets if b >= len(r.prompt))
        return np.pad(queue.results[r.uid], (bucket - len(r.prompt), 0))
    rows = [np.stack([padded(r) for r in reqs[i:i + batch]])
            for i in range(0, len(reqs), batch)]
    return reqs, queue.results, rows, engine, counts, throughput


def serve_exact_buckets(tag, m, lens, new: int, rng):
    """``serve_queue`` over 4 prompts of each length in ``lens``, each
    length its own bucket, so no prompt is left-padded (a pad would run
    through a recurrent state, and the paged engine prefills at the exact
    length)."""
    vocab = m.cfg.vocab_size
    warm = rng.integers(0, vocab, (4, lens[0]))
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in lens for _ in range(4)]
    return serve_queue(tag, m, prompts, lens, new, warm)


def check_refusals(tag, m, kw) -> dict:
    """PagedEngine's three refusals on a recurrent stack: the prefix cache,
    chunked prefill and a draft each raise."""
    refusals = {}
    for what, extra in (("prefix_cache", dict(prefix_cache=True)),
                        ("chunk_tokens", dict(chunk_tokens=CHUNK)),
                        ("draft", dict(draft_model=m.kernel,
                                       draft_params=m.params,
                                       spec_tokens=SPEC_TOKENS))):
        try:
            PagedEngine(m.kernel, m.params, **kw, **extra)
        except ValueError as e:
            refusals[what] = str(e)
        else:
            raise AssertionError(f"[{tag}] PagedEngine took {what} on a "
                                 "recurrent stack")
    log(f"[{tag}] refused: {refusals}")
    return refusals


def serve_paged(tag, m, reqs, kw, want_launches):
    """``reqs`` through a ``PagedEngine(**kw)`` after a warm-up of its
    route, its preemptions' re-prefill lengths recorded by uid: launches
    equal to ``want_launches(cfg, engine)``, every request completed and
    every page back, a replayed decode step of the largest page bucket bit
    for bit the eager one with every slot active on pages of its own (idle
    slots' rows write into the shared null page). Returns (engine, results, report, launch counts,
    {uid: re-prefill lengths}, throughput)."""
    cfg, params = m.cfg, m.params
    dev = params["embed"].device
    warm = PagedEngine(m.kernel, params, **kw)
    n = min(200, kw["max_pages_per_seq"] * kw["page_size"] // 2)
    for u in range(2):
        warm.submit(Request(u, np.arange(1, n + u, dtype=np.int32), 3))
    warm.run()
    engine = PagedEngine(m.kernel, params, **kw)
    reprefills: dict = {}
    preempt = engine._preempt

    def recorded(slot):
        preempt(slot)
        cont = engine.pending[0]
        reprefills.setdefault(cont.uid, []).append(len(cont.prompt))
    engine._preempt = recorded
    for r in reqs:
        engine.submit(r)
    kernels.reset_launch_counts()
    results = engine.run()
    counts = kernels.launch_counts()
    rep = engine.report()
    want = want_launches(cfg, engine)
    log(f"[{tag}] served {len(results)} requests (prompts "
        f"{min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens) in {rep['steps']} "
        f"steps: {rep['prefills']} exact prefills, {rep['decode_steps']} "
        f"decode steps, {rep['preemptions']} preemptions, peak "
        f"{rep['peak_pages_in_use']} of {rep['page_pool_size']} pages; "
        f"launches {counts}; bucket_lru {rep['bucket_lru']}")
    if counts != want or sorted(results) != sorted(r.uid for r in reqs) \
            or engine.alloc.free_pages != engine.n_pages - 1:
        raise AssertionError(f"[{tag}] launches {counts} (the engine's "
                             f"counters imply {want}), completed "
                             f"{sorted(results)}, {engine.alloc.free_pages} "
                             "pages free")
    for r in reqs:
        check_result(cfg, r, results[r.uid])
    key = max((k for k in engine._buckets if isinstance(k[0], int)),
              key=lambda k: k[1])
    mp = key[1]
    token = torch.arange(SLOTS, device=dev)[:, None] * 7 + 11
    table = torch.arange(1, SLOTS * mp + 1, dtype=torch.int32,
                         device=dev).reshape(SLOTS, mp)
    lengths = mp * PAGE - 5 - torch.arange(SLOTS, dtype=torch.int32,
                                           device=dev) * 13

    def eager(pools):
        return m.kernel.decode_step_paged(params, token, pools, table,
                                          lengths)[1]
    # pages 1 .. SLOTS x mp: within the pool of an attention stack (its
    # default size); a recurrent stack's state reads no page
    check_graph_replay(f"{tag} bucket {key}", engine._buckets[key],
                       engine.cache, dict(token=token, page_table=table,
                                          lengths=lengths), eager)
    t = rep["timings"]
    throughput = throughput_line(tag, t["prefill_tokens"], t["prefill_s"],
                                 t["decode_tokens"], t["decode_s"])
    return engine, results, rep, counts, reprefills, throughput


def check_share_bound(name, kern, truth, scale):
    """For a path that launches no kernel (its kernel path is its plain
    bf16 path): each step's logits within PLAIN_LOGIT_SHARE x ``scale``
    (the fp32 logits' max) of the fp32 truth. Returns each step's distance
    and the largest share of the bound used."""
    err = [(k - t).abs().max().item() for k, t in zip(kern, truth)]
    bound = PLAIN_LOGIT_SHARE * scale
    if not max(err) <= bound:
        raise AssertionError(f"{name}: the logits are {err} from fp32, "
                             f"bound {bound:.4g}")
    return err, max(err) / bound


def run_m2_check(dev, m) -> dict:
    """17a: the full-sequence logits of M2_CHECK_BATCH x M2_CHECK_PROMPT
    tokens and the teacher-forced prefill and M2_CHECK_STEPS decode steps
    after its first M2_CHECK_PROMPT - M2_CHECK_STEPS tokens, on the kernel
    path (no kernel launched: it is the plain bf16 path) and the fp32
    truth: the kernel path's logits within PLAIN_LOGIT_SHARE of the fp32
    forward's logits' max (``check_share_bound``); the fp32 prefill and
    decode steps within 1e-3 of it from the fp32 forward at their
    positions (the recurrence against the chunked scan)."""
    cfg = m.cfg
    rng = np.random.default_rng(17)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (M2_CHECK_BATCH, M2_CHECK_PROMPT)), device=dev)
    prompt = M2_CHECK_PROMPT - M2_CHECK_STEPS
    kernels.reset_launch_counts()
    with torch.inference_mode():
        kern = m.kernel.forward(m.params, tokens)
        counts = kernels.launch_counts()
        truth = m.truth.forward(m.params32, tokens)
    if counts != no_launches():
        raise AssertionError(f"[17a] launches {counts}: the SSD stack runs "
                             "none of the kernels")
    scale = truth.abs().max().item()
    f_err, f_worst = check_share_bound("[17a] forward", [kern], [truth],
                                       scale)
    args = (tokens, prompt, M2_CHECK_STEPS + 1, M2_CHECK_PROMPT + 8)
    tf_k = teacher_forced_logits(m.kernel, m.params, *args)
    tf_t = teacher_forced_logits(m.truth, m.params32, *args)
    s_err, s_worst = check_share_bound("[17a] steps", tf_k, tf_t, scale)
    drift = max((t - truth[:, prompt - 1 + i]).abs().max().item()
                for i, t in enumerate(tf_t))
    log(f"[17a] {cfg.name}, {cfg.num_layers} layers: forward of "
        f"{M2_CHECK_BATCH} x {M2_CHECK_PROMPT} tokens, no kernel launched; "
        f"the bf16 logits {f_err[0]:.4g} from fp32 over the forward, at most "
        f"{max(s_err):.4g} over the prefill and {M2_CHECK_STEPS} decode "
        f"steps (fp32 logits' max {scale:.4g}; bound {PLAIN_LOGIT_SHARE} x "
        f"it, at most {max(f_worst, s_worst):.3f} of it used); fp32 prefill "
        f"and decode {drift:.4g} from the fp32 forward")
    if not drift <= 1e-3 * scale:
        raise AssertionError(f"[17a] the fp32 prefill and decode steps are "
                             f"{drift:.4g} from the forward")
    return {"launches": counts, "forward_err": f_err[0], "steps_err": s_err,
            "forward_bound_use": f_worst, "steps_bound_use": s_worst,
            "fp32_decode_vs_forward": drift, "logit_max": scale}


def run_m2_engine(dev, m) -> dict:
    """17b: ``serve_exact_buckets`` over 8 prompts, 4 of each of M2_LENS
    tokens, M2_NEW new tokens: no kernel launched (the SSD stack is plain,
    as the reference's); the first batch's first two served tokens the
    argmax of the kernel path's teacher-forced logits."""
    rng = np.random.default_rng(170)
    reqs, results, rows, engine, counts, throughput = serve_exact_buckets(
        "17b", m, M2_LENS, M2_NEW, rng)
    log(f"[17b] served {len(reqs)} requests of {M2_LENS} tokens through "
        f"{m.cfg.num_layers} 'ssm' layers; launches {counts}")
    if counts != no_launches():
        raise AssertionError(f"[17b] launches {counts}; the path makes none")
    plen = M2_LENS[0]
    forced = torch.as_tensor(rows[0][:, :plen + 2], device=dev)
    kern = teacher_forced_logits(m.kernel, m.params, forced, plen, 2,
                                 engine.max_len)
    greedy = torch.stack([lg.argmax(-1) for lg in kern], dim=1)
    if not torch.equal(greedy, forced[:, plen:]):
        raise AssertionError("[17b] the served greedy tokens differ from the "
                             "argmax of the kernel path's teacher-forced "
                             "logits")
    return {"reqs": reqs, "results": results, "rows": rows,
            "max_len": engine.max_len, "launches": counts,
            "throughput": throughput,
            "bucket_lru": dict(engine.lru_stats)}


def run_m2_paged(dev, m, fixed: dict) -> dict:
    """17c: PagedEngine's three refusals, then M2_PAGED requests: 17b's 8
    prompts and 8 more of 200-4000 tokens, none a page multiple
    (exact-length prefills writing each slot's state), M2_NEW new tokens
    each, SLOTS slots of M2_PAGES-page tables over a pool of M2_POOL pages,
    too few for every request at once, so slots are preempted and
    re-prefilled (``serve_paged``; at least one preemption required). No
    kernel launched. The streams of 17b's prompts against 17b's by
    ``against_engine``; decode tokens/s."""
    cfg = m.cfg
    kw = dict(batch_slots=SLOTS, page_size=PAGE, max_pages_per_seq=M2_PAGES,
              n_pages=M2_POOL)
    refusals = check_refusals("17c", m, kw)
    rng = np.random.default_rng(171)
    shared = [Request(r.uid, r.prompt, M2_NEW) for r in fixed["reqs"]]
    lens = [int(n) + (int(n) % PAGE == 0) for n in
            rng.integers(M2_PAGED_LENS[0], M2_PAGED_LENS[1] + 1,
                         M2_PAGED - len(shared))]
    others = [Request(len(shared) + i,
                      rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                      M2_NEW) for i, n in enumerate(lens)]
    reqs = shared + others
    engine, results, rep, counts, reprefills, throughput = serve_paged(
        "17c", m, reqs, kw, lambda c, e: no_launches())
    if rep["preemptions"] < 1:
        raise AssertionError("[17c] the pool never forced a preemption")
    differ = []
    for i, r in enumerate(shared):
        rows = fixed["rows"][i // 4]
        d = against_engine("17c", m, r.uid, fixed["results"][r.uid],
                           results[r.uid], rows, i % 4, len(r.prompt),
                           fixed["max_len"], engine,
                           reprefills.get(r.uid, ()), M2_PAGES)
        differ += [d] if d else []
    log(f"[17c] {len(shared) - len(differ)} of 17b's {len(shared)} prompts' "
        f"paged streams equal the Engine's token for token; preempted "
        f"{sorted(reprefills)}, re-prefilled at {reprefills}")
    return {"report": rep, "launches": counts, "throughput": throughput,
            "refusals": refusals, "differ": differ,
            "reprefills": {str(k): v for k, v in reprefills.items()}}


def run_m2_long(dev, m) -> dict:
    """17d: one prompt of LONG_PROMPT tokens (the reference's long_500k
    shape, which mamba2-130m alone runs: ``sub_quadratic``) through
    ``Engine`` at batch 1, then LONG_STEPS decode steps replayed from the
    decode graph (captured on a short prompt first): prefill seconds and
    tokens/s, decode tokens/s, the peak memory; no kernel launched; the
    decode cache's bytes those of a 4096-token prompt's cache (the state
    does not grow); the last position's logits of a kernel-path prefill
    (its argmax the served first token) within PLAIN_LOGIT_SHARE of the
    logits' max of an fp32 prefill of the same prompt
    (``check_share_bound``)."""
    cfg = m.cfg
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(172)
    prompt = rng.integers(0, cfg.vocab_size, LONG_PROMPT)
    engine = Engine(m.kernel, m.params, max_len=LONG_PROMPT + LONG_STEPS + 8)
    # capture the batch-1 decode graph on a short prompt first
    engine.generate(prompt[None, :64], 2)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = engine.generate(prompt[None, :], LONG_STEPS + 1)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    t = engine.timings[-1]
    cache = engine._buckets[("decode", 1)].cache
    short = m.kernel.init_cache(1, 4096 + LONG_STEPS + 8)
    sizes = (cache_bytes(cache), cache_bytes(short))
    log(f"[17d] {cfg.name}: one prompt of {LONG_PROMPT} tokens prefilled in "
        f"{t['prefill_s']:.3f} s ({LONG_PROMPT / t['prefill_s']:.1f} "
        f"tok/s), {LONG_STEPS} decode steps in {t['decode_s']:.4f} s "
        f"({LONG_STEPS / t['decode_s']:.1f} tok/s); peak device memory "
        f"{peak:.2f} GB; decode cache {sizes[0]} bytes (a 4096-token "
        f"prompt's: {sizes[1]}); launches {counts}")
    if counts != no_launches() or sizes[0] != sizes[1]:
        raise AssertionError(f"[17d] launches {counts}, cache bytes {sizes}")
    check_result(cfg, Request(0, prompt.astype(np.int32), LONG_STEPS + 1),
                 out.tokens[0])
    del engine, cache
    gc.collect()
    torch.cuda.empty_cache()
    tokens = torch.as_tensor(prompt[None, :], device=dev)
    last = []
    for model, params in ((m.kernel, m.params), (m.truth, m.params32)):
        with torch.inference_mode():
            t0 = time.perf_counter()
            last.append(model.prefill(params, tokens,
                                      model.init_cache(1, 8))[1].float())
            torch.cuda.synchronize()
            log(f"[17d] {model.mode} {model.cfg.compute_dtype} prefill of "
                f"{LONG_PROMPT} tokens: {time.perf_counter() - t0:.3f} s")
        gc.collect()
        torch.cuda.empty_cache()
    if int(last[0].argmax()) != int(out.tokens[0, LONG_PROMPT]):
        raise AssertionError("[17d] the served first token is not the "
                             "argmax of the kernel path's prefill logits")
    scale = last[1].abs().max().item()
    err, worst = check_share_bound("[17d]", [last[0]], [last[1]], scale)
    log(f"[17d] the last position's logits: the bf16 path {err[0]:.4g} from "
        f"the fp32 prefill (logits' max {scale:.4g}; bound "
        f"{PLAIN_LOGIT_SHARE} x it, {worst:.3f} of it used); fp32 greedy "
        f"token {int(last[1].argmax())}, kernel path "
        f"{int(last[0].argmax())}")
    return {"launches": counts, "prefill_s": t["prefill_s"],
            "prefill_tokens_per_s": LONG_PROMPT / t["prefill_s"],
            "decode_s": t["decode_s"],
            "decode_tokens_per_s": LONG_STEPS / t["decode_s"],
            "peak_memory_gb": peak, "cache_bytes": sizes[0],
            "logit_err": err[0], "logit_max": scale,
            "logit_bound_use": worst}


def run_mamba2(dev) -> dict:
    """Phase 17: mamba2-130m at published width and all 24 layers (d 768,
    24 heads of 64, d_state 128, chunk 128, vocab 50,280, tied head; 0.26
    GB in bf16), seeded weights at a trained model's scale
    (``trained_scale``), kernel mode beside the plain bf16 and fp32 paths:
    17a logits, 17b ``RequestQueue(Engine)``, 17c ``PagedEngine``, 17d the
    524,288-token prompt. Prints the init time, the peak memory and the
    phase's seconds."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    m = build_models(dev, M2_ARCH, trained=True)
    init_s = time.perf_counter() - t0
    out = {"17a": run_m2_check(dev, m)}
    fixed = run_m2_engine(dev, m)
    out["17b"] = {k: v for k, v in fixed.items()
                  if k not in ("reqs", "results", "rows")}
    out["17c"] = run_m2_paged(dev, m, fixed)
    del fixed
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    out["17d"] = run_m2_long(dev, m)
    del m
    gc.collect()
    torch.cuda.empty_cache()
    out["17"] = {"init_s": init_s, "seconds": time.perf_counter() - t0,
                 "serve_peak_memory_gb": serve_peak}
    log(f"[17] {M2_ARCH}: init {init_s:.1f} s, peak memory of 17a-17c "
        f"{serve_peak:.2f} GB, phase 17 in {out['17']['seconds']:.1f} s")
    return out


def run_mamba2_training(dev) -> dict:
    """Phase 18: mamba2-130m trained whole (24 layers), M2_TRAIN_BATCH x
    M2_TRAIN_SEQ tokens a step, remat 'full', no kernel launched, so the
    bf16 numbers are held to the fixed bounds from fp32: 18a per-leaf
    grads (``grad_check``), 18b TRAIN_STEPS steps in kernel mode and the
    fp32 curve (``training_run``)."""
    cfg = get_config(M2_ARCH)
    out = {"18a": grad_check(dev, "18a", cfg, M2_TRAIN_BATCH, M2_TRAIN_SEQ,
                             no_launches())}
    gc.collect()
    torch.cuda.empty_cache()
    out["18b"] = training_run(dev, "18b", cfg, M2_TRAIN_BATCH, M2_TRAIN_SEQ,
                              no_launches())
    return out


def ivl_cfg():
    return dataclasses.replace(get_config(IVL_ARCH),
                               num_layers=IVL_TRAIN_LAYERS)


def expected_forward_launches(cfg) -> dict:
    """One full-sequence forward of a dense stack on rung 1: per layer the
    q|k (rope in its store), v, up and down ``gemm_fused`` and one flash
    forward."""
    n = cfg.num_layers
    return {**no_launches(), "gemm_fused": 4 * n, "flash_attention_fwd": n}


def run_ivl_forward(dev, m) -> dict:
    """19a: ``vlm_forward`` at full depth on ``make_batch``'s 2 x (256
    patches + IVL_CHECK_TEXT tokens): the text positions' logits on the
    kernel path within 2x the plain bf16 path's distance from fp32 +
    1e-2; per layer 4 ``gemm_fused`` and one flash forward."""
    cfg = m.cfg
    gen = torch.Generator(device=dev).manual_seed(19)
    batch = make_batch(cfg, 2, cfg.num_patches + IVL_CHECK_TEXT,
                       generator=gen)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        kern = m.kernel.forward(m.params, batch)
        counts = kernels.launch_counts()
        plain = m.plain.forward(m.params, batch)
        truth = m.truth.forward(m.params32, batch)
    n = cfg.num_layers
    want = expected_forward_launches(cfg)
    if counts != want or kern.shape != (2, IVL_CHECK_TEXT, cfg.vocab_size):
        raise AssertionError(f"[19a] launches {counts} (the path makes "
                             f"{want}), logits {tuple(kern.shape)}")
    worst, agreement = check_logit_bound("19a", [kern], [plain], [truth])
    err = [(x - truth).abs().max().item() for x in (kern, plain)]
    log(f"[19a] {cfg.name}, {n} layers, 2 x ({cfg.num_patches} patches + "
        f"{IVL_CHECK_TEXT} text tokens): text logits {tuple(kern.shape)}, "
        f"kernel path {err[0]:.4g} from fp32, plain bf16 {err[1]:.4g}, "
        f"{worst:.3f} of the bound; greedy agreement {agreement:.3f}; "
        f"launches {counts}")
    return {"launches": counts, "logit_err": {"kernel": err[0],
                                              "plain": err[1]},
            "logit_bound_use": worst, "greedy_agreement": agreement}


def run_ivl_serving(dev, m) -> dict:
    """19b: text-only serving on the backbone, as the reference's:
    ``serve_exact_buckets`` over 8 prompts, 4 of each of IVL_LENS tokens,
    IVL_NEW new tokens (launches as phase 4's), then the same requests
    through a PagedEngine (SLOTS slots, IVL_PAGES-page tables; launches as
    phase 5's), each paged stream against the Engine's by
    ``against_engine``."""
    cfg = m.cfg
    rng = np.random.default_rng(190)
    reqs, results, rows, engine, counts, fixed_tp = serve_exact_buckets(
        "19b engine", m, IVL_LENS, IVL_NEW, rng)
    want = expected_launches(cfg, len(rows), new_tokens=IVL_NEW)
    log(f"[19b engine] served {len(reqs)} requests of {IVL_LENS} tokens; "
        f"launches {counts}")
    if counts != want:
        raise AssertionError(f"[19b engine] launches {counts}; the path "
                             f"makes {want}")
    kw = dict(batch_slots=SLOTS, page_size=PAGE, max_pages_per_seq=IVL_PAGES)
    paged, presults, rep, pcounts, reprefills, paged_tp = serve_paged(
        "19b paged", m, [Request(r.uid, r.prompt, IVL_NEW) for r in reqs],
        kw, expected_paged_launches)
    differ = []
    for i, r in enumerate(reqs):
        d = against_engine("19b", m, r.uid, results[r.uid], presults[r.uid],
                           rows[i // 4], i % 4, len(r.prompt),
                           engine.max_len, paged, reprefills.get(r.uid, ()),
                           IVL_PAGES)
        differ += [d] if d else []
    log(f"[19b] {len(reqs) - len(differ)} of {len(reqs)} streams equal "
        f"across the engines token for token")
    return {"19b engine": {"launches": counts, "throughput": fixed_tp,
                           "bucket_lru": dict(engine.lru_stats)},
            "19b paged": {"launches": pcounts, "throughput": paged_tp,
                          "report": rep, "differ": differ}}


def run_internvl(dev) -> dict:
    """Phase 19: internvl2-2b (24 layers, d 2048, 16 heads of 128 over 8
    kv heads, d_ff 8192, vocab 92,553, 256 patches) at published width,
    seeded weights at a trained model's scale: 19a ``vlm_forward`` against
    fp32, 19b text-only serving through both engines, then 19c trained at
    IVL_TRAIN_LAYERS layers on IVL_TRAIN_BATCH x IVL_TRAIN_SEQ positions
    (256 patches + the text): per-leaf grads against fp32
    (``grad_check``), TRAIN_STEPS steps beside the plain bf16 and fp32
    curves (``training_run``). (19d, the kernels at its shapes, runs with
    phase 3.)"""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    m = build_models(dev, IVL_ARCH, trained=True)
    init_s = time.perf_counter() - t0
    out = {"19a": run_ivl_forward(dev, m)}
    out.update(run_ivl_serving(dev, m))
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    del m
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ivl_cfg()
    out["19c grads"] = grad_check(dev, "19c", cfg, IVL_TRAIN_BATCH,
                                  IVL_TRAIN_SEQ,
                                  expected_train_launches(cfg, 1))
    gc.collect()
    torch.cuda.empty_cache()
    out["19c"] = training_run(dev, "19c", cfg, IVL_TRAIN_BATCH,
                              IVL_TRAIN_SEQ,
                              expected_train_launches(cfg, TRAIN_STEPS))
    if out["19c"]["peak_memory_gb"] > 75:
        raise AssertionError(f"[19c] peak {out['19c']['peak_memory_gb']:.2f}"
                             " GB: cut IVL_TRAIN_LAYERS")
    out["19"] = {"init_s": init_s, "serve_peak_memory_gb": serve_peak,
                 "seconds": time.perf_counter() - t0}
    log(f"[19] {IVL_ARCH}: init {init_s:.1f} s, serving peak "
        f"{serve_peak:.2f} GB, phase 19 in {out['19']['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 20: llama4-maverick served at published width
# ---------------------------------------------------------------------------

def kept_in_bf16(path: str) -> bool:
    """The leaves the fp32 truth reads from the bf16 serving copy, upcast
    where the plain path reaches them: the experts (``moe._expert_ffn``,
    one expert at a time), the embedding (the lookup's cast) and the head
    (``lm._logits``' cast)."""
    return "/moe/w_" in path or path in ("embed", "lm_head")


def placement_rule(n_hosts: int, free_pages: int, n_requests: int) -> list:
    """The host of each of ``n_requests`` requests submitted in order to
    ``n_hosts`` idle hosts of ``free_pages`` free pages each, by the rule
    (most free pages, then fewest queued, then lowest id): submissions
    allocate no page, so the queue lengths decide."""
    queued, hosts = [0] * n_hosts, []
    for _ in range(n_requests):
        i = min(range(n_hosts), key=lambda j: (-free_pages, queued[j], j))
        queued[i] += 1
        hosts.append(i)
    return hosts


def run_sharded(dev, m: Models) -> dict:
    """20c: 20b's requests through ``ShardedPagedEngine(n_hosts=
    MAV_HOSTS)`` of 20b's engines over the one weight copy: launches exact
    (the hosts' counters summed), the placements and ``admissions_by_host``
    exactly ``placement_rule``'s, then each host's streams token for token
    those of a lone PagedEngine fed the requests placed on it, in order
    (one engine alive at a time: each keeps its decode graphs)."""
    cfg = m.cfg
    kw = dict(batch_slots=SLOTS, page_size=PAGE, max_pages_per_seq=MAX_PAGES,
              **DENSE_PAGED)
    reqs = paged_requests(cfg, "8b")
    eng = ShardedPagedEngine(m.kernel, m.params, n_hosts=MAV_HOSTS, **kw)
    for r in reqs:
        eng.submit(r)
    kernels.reset_launch_counts()
    results = eng.run()
    counts = kernels.launch_counts()
    want = no_launches()
    for h in eng.hosts:
        for k, n in expected_paged_launches(cfg, h).items():
            want[k] += n
    rep = eng.report()
    rule = placement_rule(MAV_HOSTS, eng.hosts[0].n_pages - 1, len(reqs))
    log(f"[20c] {len(results)} requests over {MAV_HOSTS} hosts in "
        f"{rep['steps']} steps: admissions by host "
        f"{rep['admissions_by_host']}, placements {rep['placements']}; "
        f"launches {counts}")
    if counts != want:
        raise AssertionError(f"[20c] launches {counts}; the hosts' counters "
                             f"imply {want}")
    by_host = [rule.count(i) for i in range(MAV_HOSTS)]
    if rep["placements"] != {r.uid: h for r, h in zip(reqs, rule)} \
            or rep["admissions_by_host"] != by_host:
        raise AssertionError(f"[20c] placements {rep['placements']}; the "
                             f"rule gives {rule}")
    if sorted(results) != [r.uid for r in reqs]:
        raise AssertionError(f"[20c] completed {sorted(results)}")
    for r in reqs:
        check_result(cfg, r, results[r.uid])
    t = [h.report()["timings"] for h in eng.hosts]
    dec_tok, dec_s = (sum(x["decode_tokens"] for x in t),
                      sum(x["decode_s"] for x in t))
    throughput = {"decode_tokens_per_s": dec_tok / dec_s,
                  "prefill_tokens_per_s": sum(x["prefill_tokens"] for x in t)
                  / sum(x["prefill_s"] for x in t)}
    placed = {i: [r for r in reqs if rep["placements"][r.uid] == i]
              for i in range(MAV_HOSTS)}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    for i, mine in placed.items():
        lone = PagedEngine(m.kernel, m.params, **kw)
        for r in mine:
            lone.submit(r)
        got = lone.run()
        same = [r.uid for r in mine
                if np.array_equal(got[r.uid], results[r.uid])]
        log(f"[20c] host {i}: {len(same)} of {len(mine)} streams equal a "
            f"lone PagedEngine's token for token")
        if len(same) != len(mine):
            differ = [r.uid for r in mine if r.uid not in same]
            raise AssertionError(f"[20c] host {i}: requests {differ} differ "
                                 "from a lone engine's streams")
        del lone
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[20c] decode {dec_tok} tokens in {dec_s:.4f} s of the hosts' "
        f"decode ({throughput['decode_tokens_per_s']:.1f} tok/s)")
    return {"launches": counts, "steps": rep["steps"],
            "admissions_by_host": rep["admissions_by_host"],
            "placements": rep["placements"], "throughput": throughput}


def run_maverick(dev, keep: dict | None = None) -> dict:
    """Phase 20: llama4-maverick-400b-a17b at published width cut to
    MAV_LAYERS layers, all 128 experts, weights at a trained model's scale,
    kernel mode beside the plain bf16 and fp32 paths (the truth reading the
    ``kept_in_bf16`` leaves from the bf16 copy): 20a phase 8a's traffic
    through RequestQueue(Engine) and 20b phase 8b's through PagedEngine
    (128-token chunks), with phases 4's and
    5's checks (launches exact: per prefill or chunk 4 ``gemm_fused`` in
    the attention + MLP layer and 2 + 2E in the MoE layer, per decode step
    2 and 2E; a replayed decode step bit for bit the eager one; the logits
    under phase 4's bound on the kernel path's routing, the fp32 router's
    disagreement share under MAX_REROUTED), then 20c ``run_sharded``.
    Prints the init time, the peak memory and the phase's seconds. With
    ``keep`` the models and weights are handed on in ``keep["models"]``
    (phase 21a serves them again) instead of being freed."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    m = build_models(dev, MAV_ARCH, MAV_LAYERS, trained=True,
                     keep_bf16=kept_in_bf16)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    truth_gb = nbytes(*(x for p, x in named_leaves(m.params32)
                        if not kept_in_bf16(p))) / 1e9
    log(f"[20] {[k for k, _, _ in layer_slots(m.cfg)]}, "
        f"{m.cfg.moe.num_experts} experts top-{m.cfg.moe.top_k}: "
        f"{nbytes(*leaves(m.params)) / 1e9:.2f} GB of bf16 weights, "
        f"{truth_gb:.2f} GB more for the fp32 truth; init peak "
        f"{init_peak:.2f} GB")
    out = {"20a": run_slice(dev, m, tag="20a maverick")}
    del out["20a"]["teacher_forced"]
    gc.collect()
    torch.cuda.empty_cache()
    out["20b"] = run_paged_phase(dev, m, "8b", tag="20b maverick")
    gc.collect()
    torch.cuda.empty_cache()
    out["20c"] = run_sharded(dev, m)
    if keep is not None:
        keep["models"] = m
    del m
    gc.collect()
    torch.cuda.empty_cache()
    summary = {"init_s": init_s, "init_peak_gb": init_peak,
               "seconds": time.perf_counter() - t0,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "rerouted_share": {p: out[p]["routing"]["share"]
                                  for p in ("20a", "20b")},
               "decode_tokens_per_s": {
                   p: out[p]["throughput"]["decode_tokens_per_s"]
                   for p in MAV_PHASES},
               "prefill_tokens_per_s": {
                   p: out[p]["throughput"]["prefill_tokens_per_s"]
                   for p in MAV_PHASES}}
    log(f"[20] {MAV_ARCH}, {MAV_LAYERS} layers: init {init_s:.1f} s, peak "
        f"memory {summary['peak_memory_gb']:.2f} GB, phase 20 in "
        f"{summary['seconds']:.1f} s; rerouted share "
        f"{summary['rerouted_share']}; decode tok/s "
        f"{summary['decode_tokens_per_s']}; prefill tok/s "
        f"{summary['prefill_tokens_per_s']}")
    out["20"] = summary
    return out


# ---------------------------------------------------------------------------
# Phase 21: the distributed layer over torch.distributed, one NCCL rank
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def nccl_world():
    """One NCCL process group of world size 1 (a ``file://`` store in a
    temporary directory) and the (1, 1) ('data', 'model') DeviceMesh over
    it, destroyed at the end. NCCL must start: there is no stand-in."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    tmp = tempfile.mkdtemp()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        log(f"[21] NCCL process group: world {dist.get_world_size()}, "
            f"backend {dist.get_backend()}, mesh {mesh}")
        yield mesh
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def counted_drops(record: list):
    """``moe._dispatch`` patched to append each call's (choices kept and
    the most choices of one expert, as device tensors; choices; capacity)
    to ``record``."""
    orig = moe_mod._dispatch

    def dispatch(cfg, t, ids, cap):
        buf, idx, keep = orig(cfg, t, ids, cap)
        load = torch.bincount(ids.reshape(-1),
                              minlength=cfg.moe.num_experts).max()
        record.append((keep.sum(), load, keep.numel(), cap))
        return buf, idx, keep

    moe_mod._dispatch = dispatch
    try:
        yield
    finally:
        moe_mod._dispatch = orig


def drop_summary(tag, record: list) -> dict:
    """The dropped share of the expert choices by bucket capacity, and the
    most choices one expert drew in a call."""
    by_cap: dict = {}
    for kept, load, n, cap in record:
        k, t, most = by_cap.get(cap, (0, 0, 0))
        by_cap[cap] = (k + int(kept), t + n, max(most, int(load)))
    out = {int(c): {"choices": t, "dropped": t - k,
                    "share": (t - k) / t, "most_in_one_expert": most}
           for c, (k, t, most) in sorted(by_cap.items())}
    allc = sum(v["choices"] for v in out.values())
    alld = sum(v["dropped"] for v in out.values())
    log(f"[{tag}] dropped expert choices by bucket capacity: "
        + "; ".join(f"capacity {c}: {v['dropped']} of {v['choices']} "
                    f"({v['share']:.4f}; at most {v['most_in_one_expert']} "
                    f"choices of one expert in a call)"
                    for c, v in out.items())
        + f"; all {alld} of {allc} ({alld / max(allc, 1):.4f})")
    return {"by_capacity": out, "share": alld / max(allc, 1)}


def mesh_models(m: Models, impl: str, mesh) -> Models:
    """``m``'s config with its MoE on ``impl`` over ``mesh``, three ways
    (kernel, plain bf16, plain fp32), on the rank's slices of m's
    weights (one rank: the weights themselves)."""
    cfg = dataclasses.replace(m.cfg, moe=dataclasses.replace(m.cfg.moe,
                                                             impl=impl))
    dev = m.kernel.device
    kern = build_model(cfg, mode="kernel", device=dev, mesh=mesh)
    return Models(cfg, kern,
                  build_model(cfg, mode="reference", device=dev, mesh=mesh),
                  build_model(dataclasses.replace(cfg,
                                                  compute_dtype="float32"),
                              mode="reference", device=dev, mesh=mesh),
                  kern.local_params(m.params), kern.local_params(m.params32))


def run_ep_serving(dev, m: Models, mesh) -> dict:
    """21a: phase 20's weights (MAV_LAYERS layers, all 128 experts) with
    the MoE on ``moe_ep`` over the (1, 1) mesh: 20a's traffic through
    RequestQueue(Engine) with phase 4's checks (launches exact: 2
    ``gemm_fused`` an expert and MoE layer, as the dense path; the decode
    steps eager and counted; the teacher-forced logits under phase 4's
    bound, the plain ep paths on the kernel path's routing), and the
    dropped share of the served choices (capacity factor
    ``cfg.moe.capacity_factor`` at top-1 of 128)."""
    mm = mesh_models(m, "ep", mesh)
    drops: list = []
    out = run_slice(dev, mm, tag="21a maverick ep",
                    serve_ctx=lambda: counted_drops(drops))
    del out["teacher_forced"]
    out["drops"] = drop_summary("21a", drops)
    out["capacity_factor"] = mm.cfg.moe.capacity_factor
    return out


def run_tp_mixtral(dev, mesh) -> dict:
    """21b: mixtral-8x7b at TP_LAYERS layers of published width (weights
    at a trained model's scale) with the MoE on ``moe_tp`` over the (1, 1)
    mesh: a forward over BATCH x PROMPT tokens, then a prefill of the
    PROMPT tokens and TP_DECODE teacher-forced decode steps; each kernel
    path's logits under phase 4's bound against the plain bf16 and fp32
    tp paths on its routing, launches exact (per layer 2 + 2E
    ``gemm_fused`` a forward or prefill, 2E a decode step)."""
    t0 = time.perf_counter()
    dense = build_models(dev, TP_ARCH, TP_LAYERS, trained=True)
    mm = mesh_models(dense, "tp", mesh)
    del dense
    cfg = mm.cfg
    rng = np.random.default_rng(21)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size,
                                       (BATCH, PROMPT + TP_DECODE)),
                          dtype=torch.int64, device=dev)
    route, flips, drops = [], [], []
    kernels.reset_launch_counts()
    with torch.inference_mode(), counted_drops(drops):
        with routed(record=route):
            kern = mm.kernel.forward(mm.params, tokens[:, :PROMPT])
        counts_fwd = kernels.launch_counts()
        with routed(replay=route):
            plain = mm.plain.forward(mm.params, tokens[:, :PROMPT])
        with routed(replay=route, flips=flips):
            truth = mm.truth.forward(mm.params32, tokens[:, :PROMPT])
    n = cfg.num_layers
    want_fwd = {**no_launches(), "gemm_fused": 2 * n + ffn_gemms(cfg),
                "flash_attention_fwd": n}
    if counts_fwd != want_fwd or kern.shape != (BATCH, PROMPT,
                                                cfg.vocab_size):
        raise AssertionError(f"[21b] forward launches {counts_fwd} (the path "
                             f"makes {want_fwd}), logits {tuple(kern.shape)}")
    fwd_routing = check_routing("21b forward", route, flips)
    fwd_worst, _ = check_logit_bound("21b forward", [kern], [plain], [truth])
    err = [(x - truth).abs().max().item() for x in (kern, plain)]
    log(f"[21b] {cfg.name}, {n} layer(s), moe_tp over (1, 1): forward "
        f"logits {tuple(kern.shape)}, kernel path {err[0]:.4g} from fp32, "
        f"plain bf16 {err[1]:.4g}, {fwd_worst:.3f} of the bound; launches "
        f"{counts_fwd}")
    del kern, plain, truth
    kernels.reset_launch_counts()
    with counted_drops(drops):
        k, p_, t_, routes = teacher_forced_routed(
            mm, mm.kernel, mm.params, tokens, PROMPT, TP_DECODE + 1,
            PROMPT + TP_DECODE + 8)
    counts = kernels.launch_counts()
    want = expected_launches(cfg, 1, new_tokens=TP_DECODE + 1)
    if counts != want:
        raise AssertionError(f"[21b] prefill + {TP_DECODE} decode launches "
                             f"{counts}; the path makes {want}")
    routing = check_routing("21b serve", *routes)
    worst, agreement = check_logit_bound("21b serve", k, p_, t_)
    log(f"[21b] prefill of {BATCH} x {PROMPT} and {TP_DECODE} decode steps: "
        f"kernel-path logits at most {worst:.3f} of the bound; greedy "
        f"agreement with plain bf16 {agreement:.3f}; launches {counts}")
    total = {key: counts_fwd[key] + counts[key] for key in counts}
    out = {"launches": total, "forward_logit_err": {"kernel": err[0],
                                                    "plain": err[1]},
           "forward_bound_use": fwd_worst, "serve_bound_use": worst,
           "routing": {"forward": fwd_routing, "serve": routing},
           "drops": drop_summary("21b", drops),
           "seconds": time.perf_counter() - t0}
    del mm, k, p_, t_
    return out


def event_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device milliseconds of ``fn`` between CUDA events, run
    eagerly (a collective's NCCL call is not captured in a graph), each
    after the Timer's 128 MiB write scrub (a cold L2)."""
    scrub = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        scrub.zero_()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_collective_gemm(dev, mesh, gen) -> tuple:
    """21c: ``gemm_collective`` at COLL_SHAPE over the (1, 1) mesh's
    'model' axis, both variants and both plans: ring and gather bit for
    bit, each within phase 3's tolerance of the plain product (the
    oracle), one ``gemm_fused`` launch each (one rank: one panel), timed
    eagerly between CUDA events beside the lone ``gemm_fused`` (timed so
    and by ``Timer``). Returns (the phase's record, phase 3's rows of the
    ring's panel launches for the kernel line)."""
    m_, k_, n_ = COLL_SHAPE
    bf16 = torch.bfloat16
    x = torch.randn((m_, k_), generator=gen, device=dev).to(bf16)
    w = (torch.randn((k_, n_), generator=gen, device=dev)
         * k_ ** -0.5).to(bf16)
    got, ms = {}, {}
    kernels.reset_launch_counts()
    for variant in ("all_gather", "reduce_scatter"):
        for plan in ("ring", "gather"):
            got[variant, plan] = gemm_collective_sharded(
                x, w, mesh=mesh, variant=variant, plan=plan, mode="kernel")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {**no_launches(), "gemm_fused": 4}
    if counts != want:
        raise AssertionError(f"[21c] launches {counts}; one panel each "
                             f"makes {want}")
    errs = {}
    for variant in ("all_gather", "reduce_scatter"):
        ring, gather = got[variant, "ring"], got[variant, "gather"]
        if not torch.equal(ring, gather):
            raise AssertionError(f"[21c] {variant}: ring and gather differ "
                                 f"by {(ring - gather).abs().max().item():.4g}")
        oracle = gemm_collective_oracle(x, w, variant=variant, axis_size=1)
        if variant == "reduce_scatter":
            oracle = oracle[0]
        errs[variant] = check_close(f"[21c] {variant}", ring, oracle,
                                    2 ** -6, 2e-2)[0]
    for variant in ("all_gather", "reduce_scatter"):
        for plan in ("ring", "gather"):
            ms[f"{variant}.{plan}"] = event_ms(
                lambda: gemm_collective_sharded(x, w, mesh=mesh,
                                                variant=variant, plan=plan,
                                                mode="kernel"))
    plan = panel_plan(m_, n_, k_, dev)

    def lone(f32=False):
        return gemm_ops._launch(x, w, EPILOGUE_NONE, b2=None, bias=None,
                                residual=None, scale=None, sin=None, cos=None,
                                gamma=None, eps=None, out_dtype=bf16,
                                plan=plan, f32_product=f32)[0]

    ms["lone"] = event_ms(lone)
    timer = Timer(dev)
    rows = []
    for case, f32 in (("ring_panel_all_gather", False),
                      ("ring_panel_reduce_scatter_f32", True)):
        out = lone(f32)
        want_p = (x.float() @ w.float()).to(out.dtype)
        err, tol = check_close(f"gemm_fused[{case}]", out, want_p, 2 ** -6,
                               2e-2)
        # the f32 panel also writes the bf16 store of the staged route
        written = (out, torch.empty((m_, n_), dtype=bf16, device=dev)) \
            if f32 else (out,)
        b_ms, b_by = bound(nbytes(x, w, *written), (2 * m_ * n_ * k_,
                                                     PEAK_BF16))
        rows.append(dict(
            case=case, shape=[m_, k_, n_], max_abs_err=err, tolerance=tol,
            saves_preacts=False, ms=timer.ms(lambda: lone(f32)),
            plain_ms=timer.ms(lambda: (x.float() @ w.float()).to(
                out.dtype)),
            library_ms=timer.ms(lambda: torch.matmul(x, w)),
            bound_ms=b_ms, bound_by=b_by, plan=f"{plan[0]}x{plan[1]}",
            ms_by_plan={}))
    ms["lone_timer"] = rows[0]["ms"]
    del timer
    log(f"[21c] gemm_collective at M {m_}, K {k_}, N {n_} over one rank: "
        f"ring == gather bit for bit (both variants); max abs err vs the "
        f"plain product {errs}; device us (events, eager): "
        f"{ {k_: round(v * 1e3, 1) for k_, v in ms.items()} }; launches "
        f"{counts}")
    return {"launches": counts, "max_abs_err": errs, "ms": ms,
            "panel_plan": list(plan)}, rows


def dp_run(dev, mode: str, mesh=None) -> dict:
    """DIST_STEPS steps of llama-1b (16 layers, phase 6b's data and
    schedule) with ``grad_compress``, from seed 0: the single-device
    trainer, or with ``mesh`` the data-parallel ZeRO-1 one (its state from
    ``sharded_init``). Returns the losses, step seconds, launches and the
    final state."""
    cfg = get_config("llama-1b")
    model = build_model(cfg, mode=mode, device=dev, mesh=mesh)
    opt = AdamWConfig(schedule=cosine_schedule(TRAIN_LR, 2, TRAIN_STEPS))
    if mesh is None:
        state = init_state(model, 0, grad_compress=True)
        step = make_train_step(model, opt, grad_compress=True)
        data = train_data(cfg, dev, TRAIN_BATCH, TRAIN_SEQ)
    else:
        state = sharded_init(model, 0, mesh, zero1=True, grad_compress=True)
        step = make_train_step(model, opt, grad_compress=True, mesh=mesh,
                               zero1=True)
        data = DataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=TRAIN_SEQ,
                                       global_batch=TRAIN_BATCH),
                            device=dev, mesh=mesh)
    losses, secs = [], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    rec = None
    for i in range(DIST_STEPS):
        batch = next(data)
        t0 = time.perf_counter()
        # the first mesh step counts its 'model' collectives (f, g and the
        # gathers: the obs counters "tp.*"); the step times after it are
        # the ones kept
        with (obs.capture() if i == 0 and mesh is not None
              else contextlib.nullcontext()) as cap:
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        rec = cap if cap is not None else rec
        secs.append(time.perf_counter() - t0)
    counts = kernels.launch_counts()
    per_step = None if rec is None else {
        "tp.collectives": rec.counters.get("tp.collectives", 0),
        "tp.gathered_leaves": rec.counters.get("tp.gathered_leaves", 0),
        "gemm_fused": counts["gemm_fused"] // DIST_STEPS}
    return {"losses": losses, "step_seconds": secs, "launches": counts,
            "per_step": per_step, "state": state, "model": model}


def same_state(a, b) -> list:
    """The paths of the leaves that differ (tensors bit for bit, ints)."""
    return [k for (k, x), (_, y) in zip(named_leaves(a), named_leaves(b))
            if not (torch.equal(x, y) if torch.is_tensor(x) else x == y)]


def run_dp_training(dev, mesh, base_step_s: float) -> dict:
    """21d: llama-1b at phase 6b's shape, DIST_STEPS steps with the mesh,
    ZeRO-1 and grad_compress, and the single-device trainer at the same
    seed, data and levers. The mesh run is the tensor-parallel step at a
    'model' extent of 1 (``distributed.tensor_parallel``: f, g and the
    gathers return their input at one rank, the vocab-parallel cross
    entropy's log-sum-exp over one rank the local one bit for bit, AdamW
    on slices elementwise):
    on the plain bf16 path the two runs' losses and final states (params,
    moments, residuals) bit for bit; in kernel mode the two runs' curves
    are compared against the spread of two single-device runs, 2 x spread
    + 0.01 (the flash backward adds dq's partial sums with atomics in an
    order that changes from run to run, so two kernel-mode runs of one
    trainer are not bit for bit), the first step's loss equal (before any
    update the forward is deterministic; the split MLP's down GEMM hands
    its fp32 accumulators to the sum over 'model' and adds the residual
    after it in fp32, the fused store's sum with its one rounding),
    launches exact. A further mesh step, counted, gives the 'model' collectives
    and the gemm_fused launches a step. Step times beside 6b's. Then
    llama-1b at DIST_CKPT_LAYERS layers takes DIST_STEPS mesh steps, and
    its state is saved (global leaves) and restored through
    ``restore(mesh=, specs=)`` into a fresh state bit for bit."""
    t0 = time.perf_counter()
    out = {}
    runs = {}
    for mode in ("reference", "kernel"):
        single = dp_run(dev, mode)
        # the state to hold the mesh run to, bit for bit (plain path only)
        keep = ({k: v.detach().clone() if torch.is_tensor(v) else v
                 for k, v in named_leaves(single["state"])}
                if mode == "reference" else None)
        runs[mode, "single"] = {k: v for k, v in single.items()
                                if k not in ("state", "model")}
        del single
        torch.cuda.empty_cache()
        if mode == "kernel":
            again = dp_run(dev, mode)
            runs[mode, "again"] = {k: v for k, v in again.items()
                                   if k not in ("state", "model")}
            del again
            torch.cuda.empty_cache()
        meshed = dp_run(dev, mode, mesh)
        runs[mode, "mesh"] = {k: v for k, v in meshed.items()
                              if k not in ("state", "model")}
        log(f"[21d] {mode}: one split step over (1, 1) makes "
            f"{meshed['per_step']['tp.collectives']} 'model' collectives "
            f"(f, g and gathers, none over one rank; "
            f"{meshed['per_step']['tp.gathered_leaves']}"
            f" leaves gathered) and {meshed['per_step']['gemm_fused']} "
            f"gemm_fused launches")
        diff = [k for k, v in named_leaves(meshed["state"])
                if keep is not None and not (
                    torch.equal(v, keep[k]) if torch.is_tensor(v)
                    else v == keep[k])]
        del keep
        s1, sm = runs[mode, "single"], runs[mode, "mesh"]
        want = expected_train_launches(get_config("llama-1b"), DIST_STEPS) \
            if mode == "kernel" else no_launches()
        for tag in ("single", "mesh"):
            if runs[mode, tag]["launches"] != want:
                raise AssertionError(f"[21d] {mode} {tag}: launches "
                                     f"{runs[mode, tag]['launches']}; the "
                                     f"steps make {want}")
        log(f"[21d] {mode}: single-device losses {s1['losses']}; mesh "
            f"(ZeRO-1, grad_compress) losses {sm['losses']}"
            + (f"; {len(diff)} state leaves differ" if mode == "reference"
               else ""))
        if mode == "reference":
            if s1["losses"] != sm["losses"] or diff:
                raise AssertionError(f"[21d] plain bf16: the mesh run is not "
                                     f"the single-device run bit for bit "
                                     f"(losses {sm['losses']} vs "
                                     f"{s1['losses']}; leaves {diff[:5]})")
            out["plain_bitwise"] = True
        else:
            again = runs[mode, "again"]["losses"]
            spread = max(abs(a - b) for a, b in zip(s1["losses"], again))
            gap = max(abs(a - b) for a, b in zip(s1["losses"], sm["losses"]))
            log(f"[21d] kernel: two single-device runs {spread:.4g} apart "
                f"(losses {again}), the mesh run {gap:.4g} from the first "
                f"(bound 2 x spread + 0.01); first step's loss equal "
                f"{sm['losses'][0] == s1['losses'][0]}")
            if sm["losses"][0] != s1["losses"][0] or \
                    not gap <= 2 * spread + 0.01:
                raise AssertionError(f"[21d] kernel: mesh losses "
                                     f"{sm['losses']} vs {s1['losses']}")
            out["kernel_spread"], out["kernel_gap"] = spread, gap
        del meshed
        torch.cuda.empty_cache()
    med = {f"{mode} {tag}": statistics.median(r["step_seconds"][1:])
           for (mode, tag), r in runs.items()}
    log(f"[21d] step seconds (median after the first): "
        f"{ {k: round(v, 4) for k, v in med.items()} } beside 6b's "
        f"{base_step_s:.4f} (kernel, no compression, 8 steps)")
    # the checkpoint at DIST_CKPT_LAYERS layers of the same model: a
    # sharded save of the mesh run's state after DIST_STEPS steps, restored
    # through restore(mesh=, specs=) into a fresh state of another seed
    cfg = dataclasses.replace(get_config("llama-1b"),
                              num_layers=DIST_CKPT_LAYERS)
    model = build_model(cfg, mode="kernel", device=dev, mesh=mesh)
    ckpt_state = sharded_init(model, 0, mesh, zero1=True, grad_compress=True)
    step_fn = make_train_step(model, AdamWConfig(schedule=cosine_schedule(
        TRAIN_LR, 2, TRAIN_STEPS)), grad_compress=True, mesh=mesh,
        zero1=True)
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH), device=dev,
                        mesh=mesh)
    for _ in range(DIST_STEPS):
        step_fn(ckpt_state, next(data))
    specs = state_shardings(model, mesh, zero1=True, grad_compress=True)
    tmp = tempfile.mkdtemp()
    try:
        c0 = time.perf_counter()
        ckpt_lib.save(ckpt_state, tmp, DIST_STEPS, mesh=mesh, specs=specs)
        save_s = time.perf_counter() - c0
        c0 = time.perf_counter()
        restored, step = ckpt_lib.restore(
            tmp, sharded_init(model, 5, mesh, zero1=True, grad_compress=True),
            mesh=mesh, specs=specs)
        restore_s = time.perf_counter() - c0
        bad = same_state(restored, ckpt_state)
        if step != DIST_STEPS or bad:
            raise AssertionError(f"[21d] restored step {step}, leaves "
                                 f"{bad[:5]} differ from the saved state")
        nbytes = sum(t.numel() * t.element_size()
                     for _, t in named_leaves(ckpt_state)
                     if torch.is_tensor(t))
        log(f"[21d] the step-{DIST_STEPS} checkpoint of llama-1b at "
            f"{DIST_CKPT_LAYERS} layers ({nbytes / 1e9:.2f} GB of state, "
            f"global leaves) restored through restore(mesh=, specs=) into a "
            f"fresh state bit for bit; save {save_s:.1f} s, restore "
            f"{restore_s:.1f} s")
        del restored
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del ckpt_state, model, step_fn
    out.update(launches=runs["kernel", "mesh"]["launches"],
               runs={f"{m} {t}": r for (m, t), r in runs.items()},
               step_s=med, base_step_s=base_step_s,
               checkpoint_s={"save": save_s, "restore": restore_s},
               seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 22: tensor-parallel training over one NCCL rank
# ---------------------------------------------------------------------------

def tp_gemm_cases(dev, gen, extent: int):
    """Phase 22b's forward GEMMs at a rank's shapes over a 'model' extent of
    ``extent`` (M = TRAIN_BATCH x TRAIN_SEQ tokens), as (name, a, b,
    kwargs, save_preact): llama-1b's q|k (+ rope) and v on the rank's
    heads behind the rmsnorm prologue, its SwiGLU up on the rank's F
    columns and its row-split down, whose partial product is the fp32
    accumulators (``f32_product``); mixtral-8x7b's q|k and v on the rank's
    heads and, under ``moe_tp``, an expert's up and down on the rank's F
    slice at the capacity bucket's rows. The weights at std K^-1/2."""
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)

    m = TRAIN_BATCH * TRAIN_SEQ
    cases = []
    for arch in ("llama-1b", MOE_ARCH):
        cfg = get_config(arch)
        d, hd = cfg.d_model, cfg.head_dim
        h, hkv, f = (cfg.num_heads // extent, cfg.num_kv_heads // extent,
                     cfg.d_ff // extent)
        tag = f"{'llama' if arch == 'llama-1b' else 'mixtral'}_tp{extent}"
        rms = dict(prologue=Prologue(norm="rmsnorm"),
                   gamma=(1 + 0.1 * torch.randn(d, generator=gen,
                                                device=dev)).to(bf16))
        sin, cos = rope_tables(torch.arange(TRAIN_SEQ, device=dev), hd,
                               cfg.rope_theta)
        x, wd = rnd(m, d), d ** -0.5
        cases += [
            (f"{tag}_qk_rope", x, rnd(d, (h + hkv) * hd, std=wd),
             dict(epilogue=Epilogue(rope=True, head_dim=hd),
                  sin=sin.repeat(TRAIN_BATCH, 1),
                  cos=cos.repeat(TRAIN_BATCH, 1), **rms)),
            (f"{tag}_v", x, rnd(d, hkv * hd, std=wd), dict(**rms))]
        up = dict(epilogue=Epilogue(activation="silu", gate=True),
                  b2=rnd(d, f, std=wd))
        if cfg.moe is None:
            cases += [(f"{tag}_swiglu_up", x, rnd(d, f, std=wd),
                       dict(up, **rms)),
                      (f"{tag}_down_f32", rnd(m, f), rnd(f, d, std=f ** -0.5),
                       dict(f32_product=True))]
        else:
            rows = moe_mod._capacity(m, cfg)
            cases += [(f"{tag}_expert_up", rnd(rows, d), rnd(d, f, std=wd),
                       up),
                      (f"{tag}_expert_down", rnd(rows, f),
                       rnd(f, d, std=f ** -0.5), {})]
    return [(*c, False) for c in cases]


def measure_tp(dev, gen, timer) -> dict:
    """Phase 22b: phase 3's rows at a rank's shapes over 'model' extents
    TP_EXTENTS: the forward GEMMs (``tp_gemm_cases``, the planned launch),
    their backward (the down's from a bf16 cotangent, as the split step
    rounds it), the flash forward and backward on the rank's heads at the
    training shape (llama-1b's head_dim 64, mixtral's 128; the local GQA
    group is the model's). Returns {kernel name: rows}."""
    bf16 = torch.bfloat16
    rows = {"gemm_fused": [], "flash_attention_fwd": [],
            "flash_attention_bwd": []}
    for extent in TP_EXTENTS:
        cases = tp_gemm_cases(dev, gen, extent)
        rows["gemm_fused"] += measure_gemm(None, dev, gen, timer,
                                           cases=cases, sweep_plans=False)
        bwd, _ = measure_gemm_bwd(
            None, dev, gen, timer, sweep_widths=False,
            cases=[(n, a, b, {k: v for k, v in kw.items()
                              if k != "f32_product"})
                   for n, a, b, kw, _ in cases])
        for name, r in bwd.items():
            rows.setdefault(name, []).extend(r)
        del cases
        for arch in ("llama-1b", MOE_ARCH):
            cfg = get_config(arch)
            h, hkv, hd = (cfg.num_heads // extent,
                          cfg.num_kv_heads // extent, cfg.head_dim)
            case = (f"{'llama' if arch == 'llama-1b' else 'mixtral'}_tp"
                    f"{extent}_train")
            qk = torch.randn(TRAIN_BATCH, TRAIN_SEQ, (h + hkv) * hd,
                             generator=gen, device=dev).to(bf16)
            v = torch.randn(TRAIN_BATCH, TRAIN_SEQ, hkv * hd, generator=gen,
                            device=dev).to(bf16)
            q = qk[..., : h * hd].reshape(TRAIN_BATCH, TRAIN_SEQ, h,
                                          hd).transpose(1, 2)
            k = qk[..., h * hd:].reshape(TRAIN_BATCH, TRAIN_SEQ, hkv,
                                         hd).transpose(1, 2)
            v = v.reshape(TRAIN_BATCH, TRAIN_SEQ, hkv, hd).transpose(1, 2)
            fwd = flash_row(case, q, k, v, True, timer)
            del fwd["kernel"]
            rows["flash_attention_fwd"].append(fwd)
            do = torch.randn(TRAIN_BATCH, TRAIN_SEQ, h, hd, generator=gen,
                             device=dev).to(bf16).transpose(1, 2)
            rows["flash_attention_bwd"].append(
                flash_bwd_row(case, q, k, v, do, True, timer))
            del qk, q, k, v, do
    for name, rs in rows.items():
        log(f"[22b] {name} at the ranks' shapes: "
            + "; ".join(f"{r['case']} {r['ms'] * 1e3:.1f} us (bound "
                        f"{r['bound_ms'] * 1e3:.2f}, plain "
                        f"{r['plain_ms'] * 1e3:.1f})" for r in rs))
    return rows


def tp_models(dev, impl: str, mesh):
    """Phase 13's mixtral config with its MoE on ``impl``, three ways over
    ``mesh`` (kernel, plain bf16, plain fp32), each a tensor-parallel
    rank's (``Model.tp``), and the seeded weights at a trained model's
    scale in fp32."""
    base = moe_train_cfg()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe,
                                                            impl=impl))
    out = []
    for mode, dtype in (("kernel", "bfloat16"), ("reference", "bfloat16"),
                        ("reference", "float32")):
        model = build_model(dataclasses.replace(cfg, compute_dtype=dtype),
                            mode=mode, device=dev, mesh=mesh)
        out.append(dataclasses.replace(model, data_axes=(),
                                       tp=TensorParallel(model, mesh)))
    params = trained_scale(out[0], out[0].init(seed=0,
                                               dtype=cfg.param_dtype))
    return cfg, out, params


def run_tp_training(dev, mesh, base: dict) -> dict:
    """22a: mixtral-8x7b at MOE_TRAIN_LAYERS layer(s) of published width
    (phase 13's config, weights at a trained model's scale) trained
    through ``moe_ep`` and again through ``moe_tp`` over the (1, 1) mesh:
    per impl, every leaf's grad of one batch on the split path against
    the fp32 truth within 2 x the plain bf16 path's distance + 1e-3, the
    plain paths routed as the kernel path (``routed``); then
    TP_TRAIN_STEPS steps of ``make_train_step(mesh=)`` in kernel mode
    (launches exact: phase 13's per layer and step), the step time and
    peak memory against phase 13b's single-device step, the dropped share
    of the expert choices and the launches by block kind."""
    out = {}
    for impl in ("ep", "tp"):
        t0 = time.perf_counter()
        tag = f"22a {impl}"
        cfg, (kern_m, plain_m, truth_m), params = tp_models(dev, impl, mesh)
        batch = next(train_data(cfg, dev))
        route, flips = [], []

        def grads(model, ctx):
            p = tree_map(lambda t: t.detach().clone().requires_grad_(),
                         params)
            kernels.reset_launch_counts()
            with ctx:
                loss, metrics, g = loss_and_grads(model, p, batch)
            torch.cuda.synchronize()
            return (float(loss), {path: x.float() for (path, _), x
                                  in zip(named_leaves(p), g)},
                    kernels.launch_counts())

        k_loss, kern, counts = grads(kern_m, routed(record=route))
        want = expected_moe_train_launches(cfg, 1)
        if counts != want:
            raise AssertionError(f"[{tag}] grad launches {counts}; one step "
                                 f"makes {want}")
        p_loss, plain, _ = grads(plain_m, routed(replay=route))
        t_loss, truth, _ = grads(truth_m, routed(replay=route, flips=flips))
        routing = check_routing(tag, route, flips)
        worst = 0.0
        for path, t_ in truth.items():
            k_err = (kern[path] - t_).abs().max().item()
            p_err = (plain[path] - t_).abs().max().item()
            if not k_err <= 2.0 * p_err + 1e-3:
                raise AssertionError(f"[{tag}] {path}: split-path grad "
                                     f"{k_err:.4g} from fp32, plain bf16 "
                                     f"{p_err:.4g}")
            worst = max(worst, k_err / (2.0 * p_err + 1e-3))
        del kern, plain, truth, plain_m, truth_m
        torch.cuda.empty_cache()
        log(f"[{tag}] {cfg.name}, {cfg.num_layers} layer(s) at published "
            f"width through moe_{impl} over (1, 1): loss kernel "
            f"{k_loss:.5f}, plain bf16 {p_loss:.5f}, fp32 {t_loss:.5f}; every "
            f"leaf's split-path grad within 2 x plain bf16 + 1e-3 of fp32, "
            f"at most {worst:.3f} of it")
        state = sharded_init(kern_m, 0, mesh, zero1=True, params=params)
        del params
        step = make_train_step(kern_m, AdamWConfig(schedule=cosine_schedule(
            TRAIN_LR, 2, TRAIN_STEPS)), mesh=mesh, zero1=True)
        data = DataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=TRAIN_SEQ,
                                       global_batch=TRAIN_BATCH),
                            device=dev, mesh=mesh)
        drops, losses, secs = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with counted_drops(drops):
            for _ in range(TP_TRAIN_STEPS):
                b = next(data)
                s0 = time.perf_counter()
                state, metrics = step(state, b)
                losses.append(float(metrics["loss"]))
                secs.append(time.perf_counter() - s0)
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        want = expected_moe_train_launches(cfg, TP_TRAIN_STEPS)
        if counts != want:
            raise AssertionError(f"[{tag}] launches {counts}; "
                                 f"{TP_TRAIN_STEPS} steps make {want}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"[{tag}] losses {losses}")
        step_s = statistics.median(secs[1:])
        # a layer's forward GEMMs (q|k, v and its FFN's), again in the
        # recompute, by block kind
        by_kind = {}
        for i in range(cfg.num_layers):
            kind = cfg.layer_kind(i)
            ffn = 2 * cfg.moe.num_experts if kind == "moe" else 2
            by_kind[kind] = by_kind.get(kind, 0) + 2 * (2 + ffn)
        log(f"[{tag}] {TP_TRAIN_STEPS} split steps of {TRAIN_BATCH} x "
            f"{TRAIN_SEQ} tokens: losses {[round(x, 4) for x in losses]}; "
            f"step {step_s:.4f} s (median after the first; phase 13b's "
            f"single-device step {base['step_s']:.4f} s), peak "
            f"{peak:.2f} GB (13b {base['peak_memory_gb']:.2f} GB); "
            f"gemm_fused launches a step by block kind {by_kind}; launches "
            f"{counts}")
        out[tag] = {"launches": counts, "losses": losses,
                    "step_seconds": secs, "step_s": step_s,
                    "peak_memory_gb": peak, "grad_bound_use": worst,
                    "routing": routing, "losses_grad": {
                        "kernel": k_loss, "plain": p_loss, "truth": t_loss},
                    "drops": drop_summary(tag, drops),
                    "seconds": time.perf_counter() - t0}
        del state, step, kern_m
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 23: the other families' tensor-parallel training over one NCCL rank
# ---------------------------------------------------------------------------

def tpf_gemm_cases(dev, gen, extent: int):
    """Phase 23b's forward GEMMs at a rank's shapes over a 'model' extent
    of ``extent``, as (name, a, b, kwargs, save_preact): bert-110m's and
    whisper-base's encoder (phases 9c and 9d: M 4096 and 6000, the
    layernorm + beta prologue, the gelu up) and internvl2-2b's (phase 19c:
    M 8192, q|k + rope at head_dim 128, the SwiGLU up) q|k and v on the
    rank's heads, up on its F columns and the row-split down as its fp32
    partial (``f32_product``); recurrentgemma-2b's geglu MLP (phase 16: M
    8192) the same. The weights at std K^-1/2."""
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)

    cases = []
    for tag, m, arch in (("bert", 4096, "bert-110m"),
                         ("whisper_enc", 6000, "whisper-base"),
                         ("ivl", IVL_TRAIN_BATCH * IVL_TRAIN_SEQ, IVL_ARCH),
                         ("rg", RG_TRAIN_BATCH * RG_TRAIN_SEQ, RG_ARCH)):
        cfg = get_config(arch)
        d, hd = cfg.d_model, cfg.head_dim
        h, hkv, f = (cfg.num_heads // extent, cfg.num_kv_heads // extent,
                     cfg.d_ff // extent)
        tag = f"{tag}_tp{extent}"
        gamma = (1 + 0.1 * torch.randn(d, generator=gen,
                                       device=dev)).to(bf16)
        if cfg.norm == "layernorm":
            pro = dict(prologue=Prologue(norm="layernorm", beta=True),
                       gamma=gamma, beta=rnd(d, std=0.5))
        else:
            pro = dict(prologue=Prologue(norm="rmsnorm"), gamma=gamma)
        x, wd = rnd(m, d), d ** -0.5
        if arch != RG_ARCH:
            qk = dict(pro)
            if cfg.rope_style == "half":
                seq = m // IVL_TRAIN_BATCH
                sin, cos = rope_tables(torch.arange(seq, device=dev), hd,
                                       cfg.rope_theta)
                qk.update(epilogue=Epilogue(rope=True, head_dim=hd),
                          sin=sin.repeat(IVL_TRAIN_BATCH, 1),
                          cos=cos.repeat(IVL_TRAIN_BATCH, 1))
            cases += [(f"{tag}_qk", x, rnd(d, (h + hkv) * hd, std=wd), qk),
                      (f"{tag}_v", x, rnd(d, hkv * hd, std=wd), dict(pro))]
        act = {"swiglu": "silu", "geglu": "gelu", "gelu": "gelu"}[cfg.mlp_act]
        up = dict(pro, epilogue=Epilogue(activation=act,
                                         gate=cfg.mlp_act != "gelu"))
        if cfg.mlp_act != "gelu":
            up["b2"] = rnd(d, f, std=wd)
        cases += [(f"{tag}_up", x, rnd(d, f, std=wd), up),
                  (f"{tag}_down_f32", rnd(m, f), rnd(f, d, std=f ** -0.5),
                   dict(f32_product=True))]
    return [(*c, False) for c in cases]


def measure_tp_families(dev, gen, timer) -> dict:
    """Phase 23b: phase 3's rows at the other families' ranks' shapes over
    'model' extents TP_EXTENTS (``tpf_gemm_cases``, planned launches; their
    backward from a bf16 cotangent), the flash forward and backward on the
    rank's heads at the training shapes (bert 8 x 512 and whisper's encoder
    4 x 1500 non-causal at head_dim 64, internvl2 4 x 2048 causal at 128,
    recurrentgemma's 5 query heads over its one kv head at extent 2, 2 x
    4096 causal in the 2048-token window at head_dim 256; its 10 heads run
    whole at extent 4); and, in plain torch (the reference's ``jnp``), the
    RG-LRU's ``proj_x``/``proj_gate`` columns and ``proj_out`` rows at the
    rank's width, by CUDA events. Returns ({kernel name: rows}, {the
    RG-LRU products' ms})."""
    bf16 = torch.bfloat16
    rows = {"gemm_fused": [], "flash_attention_fwd": [],
            "flash_attention_bwd": []}
    plain = {}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    for extent in TP_EXTENTS:
        cases = tpf_gemm_cases(dev, gen, extent)
        rows["gemm_fused"] += measure_gemm(None, dev, gen, timer,
                                           cases=cases, sweep_plans=False)
        bwd, _ = measure_gemm_bwd(
            None, dev, gen, timer, sweep_widths=False,
            cases=[(n, a, b, {k: v for k, v in kw.items()
                              if k != "f32_product"})
                   for n, a, b, kw, _ in cases])
        for name, r in bwd.items():
            rows.setdefault(name, []).extend(r)
        del cases
        for tag, arch, bsz, seq, causal, window in (
                ("bert", "bert-110m", B_BATCH, B_SEQ, False, None),
                ("whisper_enc", "whisper-base", W_TRAIN_BATCH, 1500, False,
                 None),
                ("ivl", IVL_ARCH, IVL_TRAIN_BATCH, IVL_TRAIN_SEQ, True, None),
                ("rg", RG_ARCH, RG_TRAIN_BATCH, RG_TRAIN_SEQ, True, 2048)):
            cfg = get_config(arch)
            if cfg.num_heads % extent:
                continue
            hd, h = cfg.head_dim, cfg.num_heads // extent
            hkv = max(1, cfg.num_kv_heads // extent)
            qk = rnd(bsz, seq, (h + hkv) * hd)
            q = qk[..., : h * hd].reshape(bsz, seq, h, hd).transpose(1, 2)
            k = qk[..., h * hd:].reshape(bsz, seq, hkv, hd).transpose(1, 2)
            v = rnd(bsz, seq, hkv * hd).reshape(bsz, seq, hkv,
                                                hd).transpose(1, 2)
            case = f"{tag}_tp{extent}_train"
            fwd = flash_row(case, q, k, v, causal, timer, window=window)
            del fwd["kernel"]
            rows["flash_attention_fwd"].append(fwd)
            do = rnd(bsz, seq, h, hd).transpose(1, 2)
            rows["flash_attention_bwd"].append(
                flash_bwd_row(case, q, k, v, do, causal, timer,
                              window=window))
            del qk, q, k, v, do
        w = get_config(RG_ARCH).rglru.lru_width // extent
        d = get_config(RG_ARCH).d_model
        x = rnd(RG_TRAIN_BATCH * RG_TRAIN_SEQ, d)
        wx, wo = rnd(d, w), rnd(w, d)
        hs = rnd(RG_TRAIN_BATCH * RG_TRAIN_SEQ, w)
        plain[f"rglru_proj_x_tp{extent}"] = event_ms(lambda: x @ wx)
        plain[f"rglru_proj_out_tp{extent}"] = event_ms(lambda: hs @ wo)
        del x, wx, wo, hs
    for name, rs in rows.items():
        log(f"[23b] {name} at the ranks' shapes: "
            + "; ".join(f"{r['case']} {r['ms'] * 1e3:.1f} us (bound "
                        f"{r['bound_ms'] * 1e3:.2f}, plain "
                        f"{r['plain_ms'] * 1e3:.1f}, library "
                        + ("none" if r["library_ms"] is None
                           else f"{r['library_ms'] * 1e3:.1f}") + ")"
                        for r in rs))
    log(f"[23b] the RG-LRU's products in plain torch (bf16 matmul, M "
        f"{RG_TRAIN_BATCH * RG_TRAIN_SEQ}; proj_gate as proj_x): "
        + "; ".join(f"{k} {v * 1e3:.1f} us" for k, v in plain.items()))
    return rows, plain


def tpf_cfg(arch: str):
    """Phase 23a's config of ``arch``: published width, the depth cut to
    TPF_LAYERS' (None: whole)."""
    cfg = get_config(arch)
    layers = TPF_LAYERS[arch]
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def tpf_run(dev, cfg, mode: str, params, batches, mesh=None) -> dict:
    """TPF_STEPS steps of ``cfg`` in ``mode`` from ``params`` on
    ``batches``: the single-device trainer, or with ``mesh`` the split
    step (ZeRO-1) at the mesh's extents, its 'model' collectives counted
    (the ``obs`` counters "tp.*"). Returns the losses, step seconds,
    launches, the counters and the final params."""
    model = build_model(cfg, mode=mode, device=dev, mesh=mesh)
    opt = AdamWConfig(schedule=cosine_schedule(TRAIN_LR, 2, TPF_STEPS))
    if mesh is None:
        state = init_state(model, params=params)
        step = make_train_step(model, opt)
    else:
        state = sharded_init(model, 0, mesh, zero1=True, params=params)
        step = make_train_step(model, opt, mesh=mesh, zero1=True)
    losses, secs = [], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with obs.capture() as cap:
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            secs.append(time.perf_counter() - t0)
    return {"losses": losses, "step_seconds": secs,
            "launches": kernels.launch_counts(),
            "counters": {k: v for k, v in cap.counters.items()
                         if k.startswith("tp.")},
            "params": {k: v.detach() for k, v in
                       named_leaves(state["params"])}}


def run_tp_families(dev, mesh) -> dict:
    """23a: each of TPF_LAYERS' families at published width (bert-110m and
    whisper-base whole, internvl2-2b at 2 layers, recurrentgemma-2b at one
    ('rg', 'rg', 'local') group, mamba2-130m at 4 layers), weights at a
    trained model's scale, TPF_STEPS steps of ``make_batch`` batches
    (TPF_BATCH x TPF_SEQ tokens; bert B_SEQ positions, internvl2's
    counting its patches), the split step at a 'model' extent of 1 against
    the single-device step: on the plain bf16 path the losses and the
    updated params bit for bit; in kernel mode within 2 x the spread of
    two single runs + 0.01; 0 'model' collectives; launches equal to the
    single step's; the step times side by side."""
    out = {}
    for arch in TPF_LAYERS:
        t0 = time.perf_counter()
        tag = f"23a {arch}"
        base = tpf_cfg(arch)
        seq = B_SEQ if base.family == "encoder" else TPF_SEQ
        bsz = TPF_BATCH * TPF_SEQ // seq
        gen = torch.Generator(device=dev).manual_seed(23)
        batches = [make_batch(base, bsz, seq, generator=gen)
                   for _ in range(TPF_STEPS)]
        probe = build_model(base, mode="reference", device=dev)
        params = trained_scale(probe, probe.init(seed=0,
                                                 dtype=base.param_dtype))
        del probe
        runs = {}
        for mode in ("reference", "kernel"):
            cfg = dataclasses.replace(base, compute_dtype="bfloat16")
            for run in (("single", "again", "mesh") if mode == "kernel"
                        else ("single", "mesh")):
                r = tpf_run(dev, cfg, mode, params, batches,
                            mesh if run == "mesh" else None)
                if mode == "kernel":
                    del r["params"]
                runs[mode, run] = r
                torch.cuda.empty_cache()
        plain_s, plain_m = runs["reference", "single"], runs["reference",
                                                             "mesh"]
        diff = [k for k, v in plain_s["params"].items()
                if not torch.equal(v, plain_m["params"][k])]
        if plain_s["losses"] != plain_m["losses"] or diff:
            raise AssertionError(f"[{tag}] plain bf16: the split step is not "
                                 f"the single-device step bit for bit "
                                 f"(losses {plain_m['losses']} vs "
                                 f"{plain_s['losses']}; leaves {diff[:5]})")
        for r in (plain_s, plain_m):
            del r["params"]
        k1, k2, km = (runs["kernel", t] for t in ("single", "again", "mesh"))
        spread = max(abs(a - b) for a, b in zip(k1["losses"], k2["losses"]))
        gap = max(abs(a - b) for a, b in zip(k1["losses"], km["losses"]))
        if not gap <= 2 * spread + 0.01 or not all(
                np.isfinite(km["losses"])):
            raise AssertionError(f"[{tag}] kernel: split losses "
                                 f"{km['losses']} vs {k1['losses']} (spread "
                                 f"{spread:.4g})")
        for mode in ("reference", "kernel"):
            single, meshed = runs[mode, "single"], runs[mode, "mesh"]
            if meshed["launches"] != single["launches"]:
                raise AssertionError(f"[{tag}] {mode}: split launches "
                                     f"{meshed['launches']}, single "
                                     f"{single['launches']}")
            if meshed["counters"].get("tp.collectives", 0):
                raise AssertionError(f"[{tag}] {mode}: {meshed['counters']} "
                                     "'model' collectives over one rank")
        med = {f"{m_} {t_}": statistics.median(r["step_seconds"][1:])
               for (m_, t_), r in runs.items()}
        per = {k: v // TPF_STEPS for k, v in km["launches"].items() if v}
        log(f"[{tag}] {base.name}, {base.num_layers} layers at published "
            f"width, {TPF_STEPS} steps of {bsz} x {seq}: plain bf16 split "
            f"step bit for bit the single-device one (losses "
            f"{[round(x, 5) for x in plain_s['losses']]}); kernel split "
            f"{gap:.4g} from single (bound 2 x {spread:.4g} + 0.01); 0 "
            f"'model' collectives, launches equal (a step {per}); step s (median after the first) "
            f"{ {k: round(v, 4) for k, v in med.items()} }, split / single "
            f"kernel {med['kernel mesh'] / med['kernel single']:.3f}, plain "
            f"{med['reference mesh'] / med['reference single']:.3f}")
        out[tag] = {"launches": km["launches"],
                    "runs": {f"{m_} {t_}": r for (m_, t_), r in runs.items()},
                    "kernel_spread": spread, "kernel_gap": gap,
                    "step_s": med, "seconds": time.perf_counter() - t0}
        del runs, params, batches
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 24: the policy layer on the card
# ---------------------------------------------------------------------------

# 24a: three of phase 3's prefill GEMMs (M = BATCH x PROMPT: one split),
# their candidates and the walk windows held bit for bit
POLICY_CASES = ("prefill_v", "prefill_up", "prefill_down")
POLICY_WINDOWS = (1, 4, 8, 16)
# 24c: llama-1b's depth (published width), the traffic, the training shapes
POLICY_LAYERS, POLICY_NEW = 4, 8
POLICY_TRAIN = ((4, 256), (2, 512))
POLICY_PHASES = ("24c engine", "24c paged", "24c train")


def run_policy_kernels(cfg, dev, gen) -> dict:
    """24a: at POLICY_CASES every candidate of the autotuner's forward
    signature (what the calibration times) against the plain version
    (phase 3's tolerance), and at each tile width the outputs of windows
    POLICY_WINDOWS bit for bit; then the up and down's backward (dA, dB) at
    each width across the windows bit for bit, the pick's against the plain
    backward."""
    sms = gemm_ops.sm_count(dev)
    cases = {c[0]: c for c in gemm_cases(cfg, dev, gen)}
    out = {"candidates": 0, "windows": 0, "bwd_windows": 0, "max_abs_err": 0.0}
    for name in POLICY_CASES:
        _, a, b, kw, _ = cases[name]
        ep, pro, extra = fwd_args(kw)
        want = gemm_ops.forward_ref(a, b, ep, pro, **extra)[0]
        sig = autotune.OpSignature(
            "gemm", (a.shape[0], b.shape[1], a.shape[1]),
            epilogue=None if ep.is_identity else ep,
            prologue=None if pro.is_identity else pro)
        cands = autotune.candidate_policies(sig, sms=sms)
        for pol in cands:
            got = gemm_ops.gemm_fused(a, b, epilogue=ep, prologue=pro,
                                      policy=pol, **extra)
            err, _ = check_close(
                f"24a gemm_fused[{name}] width {pol.block_n} split "
                f"{pol.splits} window {pol.window}", got, want, 2 ** -6,
                2e-2)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out["candidates"] += 1
        for w in sorted({p.block_n for p in cands}):
            outs = [gemm_ops.gemm_fused(a, b, epilogue=ep, prologue=pro,
                                        policy=gemm_policy(w, 1, win),
                                        **extra)
                    for win in POLICY_WINDOWS]
            if not all(torch.equal(outs[0], o) for o in outs[1:]):
                raise AssertionError(f"24a gemm_fused[{name}] width {w}: "
                                     "the windows' outputs differ")
            out["windows"] += len(outs)
        if name == "prefill_v":
            continue
        _, rstd, preacts = gemm_forward(
            a, b, ep, pro, save_preact=gemm_ops.kernel_saves(ep) > 0,
            **extra)
        g = torch.randn(a.shape[0], b.shape[1], generator=gen,
                        device=dev).to(torch.bfloat16)
        ops = dict(epilogue=ep, prologue=pro, b2=kw.get("b2"), bias=None,
                   scale=kw.get("scale"), sin=None, cos=None,
                   gamma=kw.get("gamma"), beta=kw.get("beta"), rstd=rstd,
                   preacts=preacts)
        want_da = gemm_bwd.gemm_bwd_da_ref(a, b, g, **ops)[0]
        want_db = gemm_bwd.gemm_bwd_db_ref(a, b, g, **ops)[0]
        for w in gemm_ops.TILE_WIDTHS:
            got = []
            for win in POLICY_WINDOWS:
                pol = gemm_policy(w, 1, win, op="gemm_bwd")
                run = gemm_bwd.BwdLaunch(a, b, g, da_policy=pol,
                                         db_policy=pol, **ops)
                run.operand_pass()
                got.append((run.da()[0].clone(), run.db()[0].clone()))
            if not all(torch.equal(got[0][0], x) and torch.equal(got[0][1], y)
                       for x, y in got[1:]):
                raise AssertionError(f"24a gemm_bwd[{name}] width {w}: the "
                                     "windows' dA or dB differ")
            out["max_abs_err"] = max(
                out["max_abs_err"],
                check_close(f"24a gemm_bwd_da[{name}] width {w}", got[0][0],
                            want_da, 2 ** -6, 2e-2)[0],
                check_close(f"24a gemm_bwd_db[{name}] width {w}", got[0][1],
                            want_db, 2 ** -6, 2e-2)[0])
            out["bwd_windows"] += len(got)
    torch.cuda.synchronize()
    log(f"[24a] {out['candidates']} forward candidates held to the plain "
        f"version (max abs err {out['max_abs_err']:.4g}); {out['windows']} "
        f"forward and {out['bwd_windows']} backward launches over windows "
        f"{POLICY_WINDOWS} bit for bit at each width")
    return out


def run_policy_calibration(out_dir) -> tuple:
    """24b: ``launch/calibrate.py --smoke`` on the card (in this process:
    its kernels are built), its table (``out_dir/CALIB_h100.json``)
    installed. The CLI's exit code is the drift gate's verdict (1: the
    analytic ranking disagrees with the card's), recorded with the
    violations and not a failure of the phase: the table holds the
    measured winners either way. Returns (the report, the phase's
    record)."""
    from repro_torch.core import calibrate as cal
    from repro_torch.launch import calibrate as calib_cli

    path = os.path.join(out_dir, "CALIB_h100.json")
    t0 = time.perf_counter()
    rc = calib_cli.main(["--smoke", "--out", path])
    with open(path) as fh:
        report = json.load(fh)
    drift = cal.check_drift(report)
    if rc != (0 if drift["ok"] else 1):
        raise AssertionError(f"24b: launch/calibrate.py --smoke exited {rc} "
                             f"with the drift gate ok={drift['ok']}")
    # the shipped table of this card loads here (the CPU refuses it)
    if not load_shipped_pretuned() or not autotune.use_pretuned(report):
        raise AssertionError("24b: the shipped or the fresh table of the "
                             "card was not installed")
    rec = {"seconds": time.perf_counter() - t0, "cells": len(report["cells"]),
           "candidates": sum(len(c["candidates"])
                             for c in report["cells"].values()),
           "families": drift["families"], "drift_ok": drift["ok"],
           "cli_exit": rc, "violations": drift["violations"],
           "best_vs_pick_us": {
               k: (min(x["measured_time_s"] for x in c["candidates"]) * 1e6,
                   c["candidates"][0]["measured_time_s"] * 1e6)
               for k, c in report["cells"].items()}}
    log(f"[24b] calibrated {rec['cells']} cells ({rec['candidates']} "
        f"candidates) in {rec['seconds']:.1f} s; drift gate "
        f"{'passed' if drift['ok'] else 'FAILED'} (exit {rc}; "
        f"{len(drift['violations'])} violations); the shipped "
        f"configs/pretuned table and then this one installed")
    return report, rec


def check_decode_pin(tag, policies: dict, report: dict, batch: int,
                     slots: int, cfg) -> bool:
    """Whether the table holds the cell of a decode launch of ``batch``
    rows over ``slots`` keys; where it does, the bucket's decode policy
    must be its pin (the key splits)."""
    hkv = cfg.num_kv_heads
    key = autotune.pretuned_cell_key(autotune.OpSignature(
        "attention_decode",
        (batch, hkv, cfg.num_heads // hkv, slots, cfg.head_dim)))
    cell = report["cells"].get(key)
    if cell is None:
        return False
    pol = policies["attention_decode"]
    spec = cell["policy"]["schedule"]
    if (pol.block_n, pol.splits) != (spec["block_n"], spec["splits"]):
        raise AssertionError(f"[{tag}] the decode bucket's policy "
                             f"{pol.describe()} is not the table's pin")
    return True


class TwoShapes:
    """Batches of the LM pipeline alternating between two (batch, seq)
    shapes, as ``train_loop`` takes a data iterator."""

    def __init__(self, cfg, dev, shapes):
        self.its = [train_data(cfg, dev, b, s) for b, s in shapes]
        self.step = 0

    def __iter__(self):
        return self

    def __next__(self):
        it = self.its[self.step % len(self.its)]
        self.step += 1
        return next(it)

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, state):
        self.step = int(state["step"])


def run_policy_models(dev, report: dict) -> dict:
    """24c: llama-1b at POLICY_LAYERS layers served by both engines with
    qkv_plan "auto" under the installed table (launches counted), its
    greedy streams against the rung auto took, explicitly pinned; the
    engines' bucket_policies; train_loop(pretuned=) over two batch
    shapes; one mixtral-8x7b layer under "auto" against the default."""
    out = {}
    cfg = dataclasses.replace(get_config("llama-1b"),
                              num_layers=POLICY_LAYERS)
    auto = build_model(cfg, mode="kernel", device=dev, qkv_plan="auto")
    params = auto.init(seed=0)
    from repro_torch.models.attention import auto_qkv
    # the rung "auto" takes at the prefill, where a block's pre-norm rides
    rung, folded = auto_qkv(cfg, BATCH * PROMPT, torch.bfloat16,
                            prenorm=(None, None), use_rope=True)
    # a fixed rung runs the same launches where it folds the norm as auto
    # does (rung 3 never folds it)
    same_path = folded == (rung != "unfused")
    pinned = build_model(cfg, mode="kernel", device=dev, qkv_plan=rung)
    rng = np.random.default_rng(24)
    prompts = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT))
    streams = {}
    for tag, model in (("auto", auto), (rung, pinned)):
        eng = Engine(model, params, max_len=MAX_LEN, pretuned=report)
        kernels.reset_launch_counts()
        with obs.capture() as cap:
            res = eng.generate(prompts, POLICY_NEW)
        torch.cuda.synchronize()
        if tag == "auto":
            pols = eng.bucket_policies
            out["24c engine"] = {
                "launches": kernels.launch_counts(),
                "bucket_policies": sorted(map(str, pols)),
                "hits": cap.counter("autotune.pretuned_hit"),
                "decode_pinned": check_decode_pin(
                    "24c", pols[("decode", BATCH)], report, BATCH, MAX_LEN,
                    cfg)}
            if set(pols) != {(BATCH, PROMPT), ("decode", BATCH)} or \
                    not out["24c engine"]["hits"]:
                raise AssertionError(f"24c: Engine.bucket_policies keys "
                                     f"{list(pols)}, table hits "
                                     f"{out['24c engine']['hits']}")
        streams[tag] = res.tokens
        del eng
    equal = np.array_equal(streams["auto"], streams[rung])
    if same_path and not equal:
        raise AssertionError(f"24c: auto took rung {rung} (norm folded "
                             f"{folded}); its greedy streams differ from "
                             "the pinned rung's")
    out["24c engine"].update(rung=rung, folded=folded, same_path=same_path,
                             streams_equal=bool(equal))
    log(f"[24c] Engine: qkv_plan 'auto' took rung {rung!r} (norm folded "
        f"{folded}); greedy streams of {BATCH} x {POLICY_NEW} tokens "
        f"{'equal' if equal else 'differ from'} the pinned rung's; "
        f"launches {out['24c engine']['launches']}; "
        f"{out['24c engine']['hits']:g} table hits, decode bucket pinned "
        f"{out['24c engine']['decode_pinned']}")
    eng = PagedEngine(auto, params, batch_slots=BATCH, page_size=PAGE,
                      max_pages_per_seq=-(-MAX_LEN // PAGE), pretuned=report)
    for u in range(BATCH):
        eng.submit(Request(u, prompts[u].astype(np.int32), POLICY_NEW))
    kernels.reset_launch_counts()
    paged = eng.run()
    torch.cuda.synchronize()
    out["24c paged"] = {"launches": kernels.launch_counts(),
                        "bucket_policies": sorted(map(str,
                                                      eng.bucket_policies))}
    for u in range(BATCH):
        if not np.array_equal(paged[u], streams["auto"][u]):
            raise AssertionError(f"24c: PagedEngine stream {u} differs from "
                                 "the Engine's")
    if not any(k[0] == BATCH for k in eng.bucket_policies
               if isinstance(k[0], int)):
        raise AssertionError(f"24c: PagedEngine.bucket_policies keys "
                             f"{list(eng.bucket_policies)}")
    log(f"[24c] PagedEngine: the {BATCH} streams equal the Engine's; "
        f"buckets {out['24c paged']['bucket_policies']}")
    del eng
    torch.cuda.empty_cache()
    logs = []
    kernels.reset_launch_counts()
    with obs.capture() as cap:
        res = train_loop(auto, TwoShapes(cfg, dev, POLICY_TRAIN), 3,
                         AdamWConfig(schedule=cosine_schedule(TRAIN_LR, 1, 3)),
                         log_every=0, pretuned=report, log=logs.append)
    torch.cuda.synchronize()
    pins = cap.counter("trainer.bucket_pins")
    if pins != 2 or sorted(res.policies) != sorted(POLICY_TRAIN) or \
            not all(np.isfinite(res.losses)):
        raise AssertionError(f"24c: train_loop pinned {pins} buckets "
                             f"{sorted(res.policies)}, losses {res.losses}")
    out["24c train"] = {"launches": kernels.launch_counts(),
                        "losses": res.losses, "pins": pins,
                        "log": [x for x in logs if "pinned" in x]}
    log(f"[24c] train_loop(pretuned=): 3 steps over {POLICY_TRAIN}, "
        f"trainer.bucket_pins {pins:g}, losses {res.losses}")
    del auto, pinned, params, res
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=1)
    mauto = build_model(mcfg, mode="kernel", device=dev, qkv_plan="auto")
    mfix = build_model(mcfg, mode="kernel", device=dev)
    mparams = mauto.init(seed=0)
    tokens = torch.from_numpy(prompts % mcfg.vocab_size).to(dev)
    t = BATCH * PROMPT
    m_rung, m_folded = auto_qkv(mcfg, t, torch.bfloat16,
                                prenorm=(None, None), use_rope=True)
    experts = autotune.select_fusion(
        "mlp", (t, mcfg.d_model, mcfg.d_ff, 1), "bfloat16",
        residual=False)["plan"]
    # the default is rung 1 with the norm folded and the experts fused
    default = (m_rung, m_folded, experts) == ("rope_fused", True, "fused")
    kernels.reset_launch_counts()
    with torch.inference_mode():
        la = mauto.forward(mparams, tokens)
        launches = kernels.launch_counts()
        lf = mfix.forward(mparams, tokens)
    torch.cuda.synchronize()
    equal = torch.equal(la, lf)
    if not torch.isfinite(la).all() or (default and not equal):
        raise AssertionError("24c: mixtral under 'auto' is not finite or, "
                             "where its plans are the default's, differs")
    out["24c mixtral"] = {"rung": m_rung, "folded": m_folded,
                          "experts": experts, "logits_equal": bool(equal),
                          "launches": launches}
    log(f"[24c] mixtral-8x7b (1 layer, published width) under 'auto': rung "
        f"{m_rung!r} (norm folded {m_folded}), experts {experts}; logits "
        f"{'bit for bit' if equal else 'not bit for bit'} the default's; "
        f"launches {launches}")
    del mauto, mfix, mparams
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_policy_routes(dev, gen) -> dict:
    """24d: ``gemm_collective(plan=None)`` at COLL_SHAPE and
    ``gemm_fused(bwd_mode="auto")`` at the training up projection's shape
    on one NCCL rank, each bit for bit the plan or mode named by the
    autotuner run explicitly."""
    m, k, n = COLL_SHAPE
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=gen, device=dev) * k ** -0.5).to(
        torch.bfloat16)
    out = {}
    with nccl_world() as mesh:
        with obs.capture() as cap:
            got = gemm_collective_sharded(x, w, mesh=mesh, plan=None)
        plan = next(c.split(".")[-1] for c in cap.counters
                    if c.startswith("gemm_collective.all_gather."))
        want = gemm_collective_sharded(x, w, mesh=mesh, plan=plan)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("24d: gemm_collective(plan=None) differs "
                                 f"from plan={plan!r}")
        out["collective_plan"] = plan
        a = torch.randn(TRAIN_BATCH * TRAIN_SEQ // 4, 2048, generator=gen,
                        device=dev).to(torch.bfloat16)
        b = (torch.randn(2048, 8192, generator=gen, device=dev)
             * 2048 ** -0.5).to(torch.bfloat16)
        b2 = (torch.randn(2048, 8192, generator=gen, device=dev)
              * 2048 ** -0.5).to(torch.bfloat16)
        ep = gemm_ops.Epilogue(activation="silu", gate=True)
        mode = autotune.select_bwd_mode(a.shape[0], 8192, 2048,
                                        dtype=a.dtype, epilogue=ep)
        grads = {}
        for tag in ("auto", mode):
            leaves_ = [t.clone().requires_grad_() for t in (a, b, b2)]
            y = gemm_ops.gemm_fused(leaves_[0], leaves_[1], b2=leaves_[2],
                                    epilogue=ep, bwd_mode=tag)
            y.float().square().mean().backward()
            grads[tag] = [t.grad for t in leaves_]
        torch.cuda.synchronize()
        if not all(torch.equal(x_, y_) for x_, y_ in
                   zip(grads["auto"], grads[mode])):
            raise AssertionError(f"24d: bwd_mode='auto' differs from "
                                 f"{mode!r}")
        out["bwd_mode"] = mode
    log(f"[24d] gemm_collective(plan=None) took {plan!r} at {COLL_SHAPE}, "
        f"bit for bit; bwd_mode 'auto' took {mode!r}, grads bit for bit")
    return out


def run_policy_layer(dev, gen, out_dir=None) -> dict:
    """Phase 24 (24a-24d); the table installed in 24b is cleared at the
    end, and the autotuner's memo with it."""
    t0 = time.perf_counter()
    cfg = get_config("llama-1b")
    phases = {"24a": run_policy_kernels(cfg, dev, gen)}
    tmp = out_dir or tempfile.mkdtemp()
    os.makedirs(tmp, exist_ok=True)
    try:
        report, phases["24b"] = run_policy_calibration(tmp)
        phases.update(run_policy_models(dev, report))
        autotune.clear_pretuned()
        phases["24d"] = run_policy_routes(dev, gen)
    finally:
        autotune.clear_pretuned()
        if out_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    log(f"[24] phase 24 in {time.perf_counter() - t0:.1f} s")
    return phases


def run_distributed(dev, m: Models, base_step_s: float, gen,
                    moe_base: dict) -> tuple:
    """Phases 21 (21a-21d), 22a and 23a inside one NCCL process group of
    world size 1; ``m``: phase 20's models, freed after 21a; ``moe_base``:
    phase 13b's record. Returns (the phases, the ring panels' rows for
    phase 3's gemm_fused)."""
    t0 = time.perf_counter()
    out = {}
    with nccl_world() as mesh:
        out["21a"] = run_ep_serving(dev, m, mesh)
        del m
        gc.collect()
        torch.cuda.empty_cache()
        out["21b"] = run_tp_mixtral(dev, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        out["21c"], rows = run_collective_gemm(dev, mesh, gen)
        out["21d"] = run_dp_training(dev, mesh, base_step_s)
        log(f"[21] phase 21 in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out.update(run_tp_training(dev, mesh, moe_base))
        log(f"[22] phase 22a in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out.update(run_tp_families(dev, mesh))
    log(f"[23] phase 23a in {time.perf_counter() - t0:.1f} s")
    return out, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report to OUT/chip_smoke.json")
    ap.add_argument("--baseline-csrc", default=None,
                    help="an earlier tree's csrc directory: time its "
                    "forward GEMM, GEMM backward (dA + dB), flash "
                    "forward and backward, decode, RoPE and fused norm "
                    "kernels in turns with this one's")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; nothing was run",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = gpu_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    build_logs = kernels.build_all()
    log(f"[build] {len(kernels.KERNELS)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in str(text).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    sass = {k.name: sass_counts(k.lib_path) for k in kernels.KERNELS}
    for name, counts in sass.items():
        log(f"[build] {name}: sass {counts}")

    build_model(get_config("llama-1b"), device=dev)   # pins fp32 numerics
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = Timer(dev)
    clean = Timer(dev, clean=True)
    floors = {"ms": timer.floor(), "clean_l2_ms": clean.floor()}
    log(f"[timer] floor (a one-element fill replayed from a graph): "
        f"{floors['ms'] * 1e3:.2f} us after the write scrub, "
        f"{floors['clean_l2_ms'] * 1e3:.2f} us after the read scrub")
    cfg = get_config("llama-1b")
    old = baseline_kernels(args.baseline_csrc) if args.baseline_csrc else None
    measured = {"gemm_fused": (measure_gemm(cfg, dev, gen, timer, old)
                               + measure_verify_gemms(cfg, dev, gen, timer)),
                "flash_attention_fwd": (
                    measure_flash(cfg, dev, gen, timer, old)
                    + measure_flash_encoder(dev, gen, timer)
                    + measure_flash_window(dev, gen, timer)),
                "flash_decode": (measure_decode(cfg, dev, gen, timer, old)
                                 + measure_decode_encoder(dev, gen, timer)
                                 + measure_decode_window(dev, gen, timer)),
                "flash_decode_paged": (
                    measure_paged(cfg, dev, gen, timer, old)
                    + measure_paged_window(dev, gen, timer))}
    for name, rows in itertools.chain(
            measure_rg_attention(dev, gen, timer).items(),
            measure_ivl_attention(dev, gen, timer).items(),
            measure_mav_attention(dev, gen, timer).items()):
        measured[name] += rows
    bwd_rows, bwd_whole = measure_gemm_bwd(cfg, dev, gen, timer, old)
    measured.update(bwd_rows)
    measured.update({
        "flash_attention_bwd": (measure_flash_bwd(cfg, dev, gen, timer, old)
                                + measure_rg_flash_bwd(dev, gen, timer)),
        "rope": measure_rope(cfg, dev, gen, timer, clean, old),
        "fused_norm": measure_fused_norm(dev, gen, timer, clean, old)})
    t_tp = time.perf_counter()
    for name, rows in measure_tp(dev, gen, timer).items():
        measured[name] += rows
    log(f"[22b] the ranks' rows in {time.perf_counter() - t_tp:.1f} s")
    t_tp = time.perf_counter()
    tpf_rows, rglru_ms = measure_tp_families(dev, gen, timer)
    for name, rows in tpf_rows.items():
        measured[name] += rows
    log(f"[23b] the other families' ranks' rows in "
        f"{time.perf_counter() - t_tp:.1f} s")
    for name, rows in measured.items():
        for r in rows:
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms'] * 1e3:.1f} us")
            log(f"[kernel] {name}[{r['case']}] shape {r['shape']}: max abs "
                f"err {r['max_abs_err']:.4g} ({r['tolerance']}); kernel "
                f"{r['ms'] * 1e3:.1f} us, plain {r['plain_ms'] * 1e3:.1f} us, "
                f"library {lib}, bound "
                f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")

    del timer, clean
    torch.cuda.empty_cache()
    m = build_models(dev)
    phases = {"4": run_slice(dev, m)}
    del phases["4"]["teacher_forced"]
    for phase in PHASES:
        phases[phase] = run_paged_phase(dev, m, phase)
    phases.update(run_ladder_serve(dev, m))
    del m
    torch.cuda.empty_cache()
    phases["6a"] = run_grad_check(dev)
    torch.cuda.empty_cache()
    phases["6b"] = run_training(dev)
    torch.cuda.empty_cache()
    phases["7b"] = run_ladder_train(dev, phases["6b"])
    torch.cuda.empty_cache()
    phases["7d"] = run_norm_op(dev)
    log(f"[done] build and phases 3-7 in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    phases.update(run_dense(dev))
    log(f"[done] phase 8 at {time.perf_counter() - t0:.1f} s")
    phases["9a"] = run_whisper(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phases["9b"] = run_bert(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phases["9c"] = run_encoder_training(dev, "9c", "bert-110m", mlm_batches,
                                        B_SEQ)
    gc.collect()
    torch.cuda.empty_cache()
    phases["9d"] = run_encoder_training(dev, "9d", "whisper-base",
                                        whisper_batches, W_TRAIN_SEQ)
    log(f"[done] phase 9 at {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    spec = run_spec(dev)
    phases.update((p, spec[p]) for p in SPEC_RUNS)
    log(f"[done] phase 10 at {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    phases.update(run_leftovers(dev, phases["6b"]))
    log(f"[done] phase 11 at {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    phases.update(run_moe(dev))
    log(f"[done] phase 12 at {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    phases["13a"] = run_moe_grad_check(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phases["13b"] = run_moe_training(dev)
    log(f"[done] phase 13 at {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    phases.update(run_telemetry(
        dev, os.path.join(args.out, "traces") if args.out else None))
    log(f"[done] phase 14 at {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    phases.update(run_recurrentgemma(dev))
    log(f"[done] phase 15 at {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    phases["16b"] = run_rg_grad_check(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phases["16c"] = run_rg_training(dev)
    log(f"[done] phase 16 at {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    phases.update(run_mamba2(dev))
    log(f"[done] phase 17 at {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    phases.update(run_mamba2_training(dev))
    log(f"[done] phase 18 at {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    phases.update(run_internvl(dev))
    log(f"[done] phase 19 at {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    held: dict = {}
    phases.update(run_maverick(dev, keep=held))
    log(f"[done] phase 20 at {time.perf_counter() - t0:.1f} s")
    dist_phases, ring_rows = run_distributed(dev, held.pop("models"),
                                             phases["6b"]["step_s"], gen,
                                             phases["13b"])
    phases.update(dist_phases)
    measured["gemm_fused"] += ring_rows
    log(f"[done] phases 21, 22 and 23 at {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    phases.update(run_policy_layer(
        dev, gen, os.path.join(args.out, "calibrate") if args.out else None))
    log(f"[done] phase 24 at {time.perf_counter() - t0:.1f} s")

    line = []
    for name, rows in measured.items():
        b_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        b_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        src, replaces = SOURCES[name]
        line.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(phases[p]["launches"][name]
                            for p in MAIN_PATH_PHASES + DENSE_PHASES
                            + ENCODER_PHASES + tuple(SPEC_RUNS)
                            + LEFTOVER_PHASES + MOE_PHASES
                            + MOE_TRAIN_PHASES + TELEMETRY_PHASES
                            + RG_PHASES + RG_TRAIN_PHASES + M2_PHASES
                            + M2_TRAIN_PHASES + IVL_PHASES + MAV_PHASES
                            + DIST_PHASES + TP_TRAIN_PHASES
                            + TPF_PHASES + POLICY_PHASES),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": b_ops + b_bytes,
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            # no one PyTorch call computes RoPE or the fused norm
            "library_ms": (None if any(r["library_ms"] is None for r in rows)
                           else sum(r["library_ms"] for r in rows)),
            "cases": rows})
    report = {"device": card, "kernels": line, "phases": phases,
              "verify_vs_serial_logit_diff":
                  spec["verify_vs_serial_logit_diff"],
              "gemm_bwd_whole": bwd_whole, "sass": sass,
              "rglru_products_tp_ms": rglru_ms,
              "timer_floor": floors}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps({"kernels": line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
