#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each on its own lines; any failure raises and exits non-zero:

1. environment: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions; TF32 is switched off for float32 products;
2. build: the hand-written kernels are compiled from the checkout's
   sources into ``build/``, one ``nvcc`` per library, all five started
   together: the GEMM (``src/repro_torch/kernels/gemm/csrc/gemm.cu``), the
   chain kernels (``src/repro_torch/kernels/chain/csrc/chain.cu``), flash
   attention (``.../flash_attention/csrc/flash_attention.cu``), its
   backward (``.../flash_attention/csrc/flash_attention_bwd.cu``) and the
   linear scan (``.../linear_scan/csrc/linear_scan.cu``); the SASS of the
   tensor-core routes must hold their instructions (HGMMA for ``wgmma``,
   the GEMM's, ``chain_dot``'s, flash attention's two, 16-bit and
   3xTF32, and the 16-bit attention backward's dq and dk/dv kernels, the
   bf16 and f16 instantiations apart (of each head dim for attention), on
   operands of their type; DMMA for the f64 MMA), read with
   ``cuobjdump``, and the tensor-core kernels of attention, the GEMM and
   ``chain_dot`` must not spill (``-Xptxas -v``);
3. the GEMM kernel against its plain PyTorch version on the card on every
   route (``kernels/gemm/ops.py`` ``route``, checked against the route the
   built launcher takes): at the main path's leaf shape 1024^3 in float32
   (``f32_3xtf32``: the TF32 tensor cores, three products), bfloat16
   (``wgmma``) and float64 (DMMA), at the ragged shapes (130, 70, 260),
   (1, 128, 1) and (130, 72, 264), in float16 at the ragged ones
   (``f16_wgmma`` at (130, 72, 264), ``f16_simt`` at the others), and on
   views at an odd element offset (float32 and bfloat16 on the CUDA
   cores), for ``matmul`` and ``matmul_accumulate``,
   the route printed beside each result and the launches by route after;
   every ``f32_3xtf32`` output (1024^3, K 8192, the aligned ragged shapes
   of ``TF32_SHAPES``) also against a float64 product: its largest error
   at most ``TF32_VS_SIMT`` times ``f32_simt``'s on the same values
   (copies at an odd offset), and two calls bit for bit (at K 4,
   ``TF32_TINY``, the float64 errors printed only); with NaNs and
   infinities among the inputs (``NON_FINITE``), NaN, +inf and -inf
   exactly where ``torch.matmul``'s are, on both float32 routes; the SASS
   of both 3xTF32 kernels holds TF32 HGMMA and they do not spill; at
   1024^3 the kernel's time beside the plain version's,
   ``torch.matmul``'s (``torch.addmm``'s for the accumulate) as a
   yardstick the port never calls, the card's bound and, in float32,
   ``f32_simt``'s on the same values; float16 at 1024^3, written as
   float16 and as float32, on ``f16_wgmma`` beside ``f16_simt`` on the
   same values one element in (CUDA-graph times, which ``f16_wgmma`` must
   beat; two calls bit for bit; its float64 error at most
   ``F16_VS_SIMT`` times ``f16_simt``'s), past 65504 on exact integer
   sums (bit for bit the plain version, inf exactly where its is) and on
   subnormal inputs (within tolerance at that scale), on both routes;
4. the chain kernels on the card: ``chain_ewise`` (``scan_step``) bit for
   bit against its plain version (a per-level PyTorch loop of ``a * y +
   x``) in float32, bfloat16, float64 and float16 over every layout (the
   carry at
   each of the three positions, the two exterior operands each single,
   per level, constant or per-level constant) at 1024^2 x 64 levels and at
   the ragged (1000, 37), and each layout's device time at 1024^2 x 64
   float32 (a CUDA graph of back-to-back launches: the wrapper's host time
   per call is above the kernel's), the main path's two layouts in
   float16 too;
   ``chain_dot`` (``gemm_tile``) at 1024^3 x 8 levels and the ragged
   (130, 70, 260) and (130, 72, 264), with per-level and shared ``a``/``b``,
   on the route per-level replay takes at every level, bit for bit
   against per-level replay of ``gemm_tile`` (what ``serial`` runs: one
   GEMM-kernel launch per level) and within the GEMM's tolerance of its
   plain version (a per-level loop of PyTorch's ``c + a @ b``); the
   kernels' times and errors on the timed inputs beside their plain
   versions' times, their bounds and, for ``chain_dot`` in each dtype,
   ``torch.addmm`` over the levels concatenated along K (float16's
   ``f16_wgmma`` chain also beside ``f16_simt``'s on the same values one
   element in, which it must beat, and both against float64), every GEMM
   route run; ``chain_attn`` (``attn_step``) at
   a Qwen3-14B query tile (o, q 512 x 128, k, v 16 levels of 512 x 128;
   ``f32_3xtf32``, ``bf16_wgmma``, ``f16_wgmma``, ``f64_simt``) and a
   ragged (100, 70, d 40, dv 24) x 3 (the CUDA-core routes), q/k/v shared
   or per level, the route ``chain_ops.attn_route`` gives checked against
   the library's launcher, bit for bit against per-level ``attn_step``
   replay and within tolerance of its plain version (a per-level PyTorch
   softmax), f32/bf16/f64/f16; each tensor-core route at the 16-level
   tile and at one served level (from a zero carry) against float64, at
   most ``TF32_VS_SIMT`` (f32) or ``CHAIN_HALF_VS_SIMT`` (bf16, f16) times
   the CUDA-core route's error on odd-offset copies of the same values,
   and timed (CUDA graphs) beside that route, which it must beat, its
   bound and the plain version; chains longer than one launch's workspace
   (levels per launch from ``kernel.levels_per_launch``; f32, bf16 and f16
   on the tensor cores, f32 at an odd offset and f64 on the CUDA cores:
   two and three launches) bit for bit against replay; every route
   launched, no counter left non-zero;
4b. flash attention (``flash_attention``) against its plain version (the
   oracle on the padded inputs) at the reference's cases
   (``tests/test_kernels.py``) in f32, again in f32, bf16 and f16 at head
   dims 64 and 128 (the tensor-core routes) with a case whose rows past
   Skv + window see no key (exactly zero), f32, bf16 and f16 cases with
   many key tiles per query tile (``MID_ATTN``: causal, windowed, ragged,
   non-causal; f32 at d 64, 80, 96, 128 and 256, bf16 and f16 at 64, 80,
   96, 128, 192 and 256), bf16 and f16 views at an odd offset at d 128
   and 96 and f32 ones (the CUDA cores), float16 at d 16 (the CUDA
   cores), h2o-danube-1.8b's head dim 80
   (bf16 and, since its 32-column panels take a last one of 16 columns,
   f32 on the tensor cores) and,
   through the entry point with every count zeroed just before, at full
   width: RecurrentGemma-9B local attention (16 heads over 1, S 8192, D
   256, window 2048), Qwen3-14B (40 over 8, S 8192, D 128) and Gemma-7B
   (16 over 16, S 4096, D 256), causal, f32 and bf16 (f32 at d 256 also
   on ``f32_simt``, q one element in, which ``f32_3xtf32`` must beat), and
   f16 at RecurrentGemma-9B's and Qwen3-14B's (``f16_wgmma``: two calls
   bit for bit, faster than the plain version and than ``f16_simt`` on
   the same values one element in);
   every call's counted route (the built launcher's for the
   operands, which the wrapper holds against ``ops.route``) checked
   against ``ops.route`` of the inputs, every route run; bf16 and f16
   also against the float32 oracle to limits scaled to each value, of
   each dtype's unit roundoff (``half_attention_error``,
   ``HALF_LIMITS``); every ``f32_3xtf32`` output also against a
   float64 computation, per head at full width: its largest error at most
   ``TF32_VS_SIMT`` times the ``f32_simt`` route's on the same inputs
   (run on copies at an odd offset); the kernel's time beside its plain
   version's, ``scaled_dot_product_attention``'s (a yardstick the port
   never calls, timed for every model and dtype) and its bound;
4c. the linear scan (``linear_scan``, one launch a call) at the
   reference's shapes, at many-chunk shapes with a short last chunk
   (``LONG_SCANS``: an odd D, and three sequences) and at RecurrentGemma-9B's
   RG-LRU width (1, 8192, 4096), in f32, bf16 and f16, each on its route
   and again on views at an odd offset (the ``ldg`` route): bit for bit
   its chunked plain version (``ref.linear_scan_chunked``) and the two
   routes each other, within the tolerance of the sequential oracle, ``a =
   0`` giving ``x`` exactly, the counted route ``ops.route``'s, both routes
   run; NaNs with every bit set in ``a`` and ``x`` (the look-back's "not
   yet" word) come out as the chunked version's; again in f32 with ``a`` in (0.999, 1], which keeps the carry across
   chunks alive, against a float64 loop (no farther from it than the f32
   plain loop); at RG-LRU width, with every count zeroed just before, f32
   and bf16: one launch, the device time of the memset and the kernel
   (CUDA graph) on both routes beside the bound, the plain loop's time and
   ``torch.add(a, x, out=y)``'s (the card's rate for the same 3 S D
   elements, a yardstick), each the better of two graphs, and the
   profile: one ``linear_scan_kernel`` a call, none of the three-pass
   kernels;
5. Listing 1 (``run_distributed_gemm``) at n=8192, ib=1024, float32, a
   2x2 grid of simulated ranks on the one card, cold then warm: 512 kernel
   launches, all ``f32_3xtf32`` (the profile: 512 ``gemm_tf32_kernel``),
   and a relative error <= 1e-4 against a float64 product;
6. Strassen (``gemm_strassen``) on the same 8x8 grid of 1024 tiles: 343
   kernel launches, all ``f32_3xtf32``, and a relative error <= 1e-3;
7. the chain path through the engine, ``LocalExecutor(1, mode="plan",
   backend=MeshBackend(pallas=True))``, cold then warm: a 64-level
   ``scan_step`` chain on a 1024^2 float32 carry with ``x`` the same every
   level, again with a fresh ``x`` per level, an 8-level ``gemm_tile``
   chain on one 1024^2 tile, and a 16-level ``attn_step`` chain on a
   Qwen3-14B query tile (512 x 128, fresh k and v per level), each in
   float32 and again in float16 (the ``gemm_tile`` chain on
   ``f16_wgmma``): one chain-kernel launch each and no GEMM launch,
   bitwise equal to ``backend="serial"`` on the card;
7b. the rank mesh (``[mesh]``, :func:`mesh_phase`): Listing 1 as in 5 on
   ``MeshBackend(devices=("cuda:0",) * 4)`` — ship lowering armed, the 4
   ranks sharing the card — once per ship schedule (``tree``, ``ring``,
   ``hierarchical``), cold then warm: C bit for bit serial's, the stats
   and transfer stream equal, every tensor ship lowered to ``ppermute``
   rounds (``ships_lowered`` = the ships, none simulated, three copies
   each), 512 ``f32_3xtf32`` launches and no body expression, every
   destination shard of the cold run storage of its own with the
   payload's bits, the memory back; the ships, copies and bytes an
   iteration, the warm wall beside serial's, and the profile (the GEMMs
   and the copies' device time apart, the card showing exactly the
   counted copies); the 64-level ``scan_step`` chain (x per level) and
   the 8-level ``gemm_tile`` chain through ``MeshBackend(pallas="auto",
   devices=("cuda:0",) * 4)``: one chain-kernel launch each, bit for bit
   serial's; ``distributed_gemm_shardmap`` on a (2, 4) rank mesh at
   8192^2 float32, ``tree`` and ``ring``, within 1e-4 relative of the
   dense product, timed beside it; ``selftest_collectives``,
   ``selftest_mesh`` and ``selftest_distgemm`` with ``--device cuda``,
   each printing ``OK``;
8. Listing 1 and Strassen under ``backend="fused"`` and
   ``backend="threads"``, cold then warm: C bitwise equal to the serial
   run's, the same transfer stream, 512 and 343 GEMM launches; then the
   reference's bar for ``threads`` (``benchmarks/bench_dag_overhead.py``:
   threads >= 0.9x serial) on both, as the median over THREADS_ROUNDS
   interleaved warm rounds of serial's wall over threads' (the side that
   goes first alternating, each run after a ``gc.collect()`` of what the
   runs left, the script's earlier heap frozen); Listing 1 in float16 (A
   and B rounded to it) on serial, fused and threads, cold then warm: 512
   ``f16_wgmma`` launches and no other, C bit for bit across the three,
   a relative error <= ``F16_LISTING_REL`` against the float64 product of
   the same float16 inputs, serial's warm run profiled; the tensor bodies
   on operands their kernels do not take (int32 and mixed-dtype
   ``gemm_tile`` and ``_t_gemm_acc``, 3-D ``attn_step`` and a float16 one
   with dv past 256): no kernel launch, one call of the body expression,
   its result the reference's, while a float16 ``attn_step`` the chain
   kernel takes is one ``chain_attn`` launch; every other run of 4b-8
   counts the body expressions too (``accumulate_body.calls``,
   ``step_body.calls``), and must make none;
   after each run of 4b-8, dropping the result must give back the device
   memory the run allocated (a finished workflow is freed by reference
   counting, not at the next cyclic garbage collection); after each warm
   run, one more run under ``torch.profiler`` prints the device time by
   kernel and the device's busy share, and checks that the card ran
   exactly the kernels that were counted;
8a. the process pool (``[procs]``, :func:`procs_phase`): Listing 1 at
   n=8192, ib=1024, float32, 2x2 ranks on ``backend="procs"``, one spawned
   worker process per rank with its own CUDA context, three iterations
   into fresh C tiles in one workflow (cold; re-shipped once A's and B's
   replicas settle; warm), against the same program on ``serial``: C bit
   for bit every iteration, the transfer stream and the stats equal, 512
   ``f32_3xtf32`` launches an iteration summed over the workers (a probe op,
   :func:`worker_probe`, reads and resets each worker's counters), four
   distinct worker processes with a CUDA context and no ``jax`` or
   ``repro`` loaded, the warm iteration one "run" message a worker, no
   serial fallback; walls beside serial's, the bytes staged between card
   and host in the workers and the share of the wall the busiest spends
   in those copies, the busy share (serial's profiled device time over the
   wall), ``/dev/shm`` sampled; after ``shutdown_pools()`` no segment left
   and the memory back; then faults (``[faults]``, :func:`faults_phase`):
   the same Listing 1 with rank 1 killed at wavefront 2, simulated on
   ``serial``, ``fused`` and ``threads``, and rank 2's worker killed for
   good by a real ``SIGKILL`` on ``procs`` (its placements re-bound onto
   ``choose_replacement``'s pick on a ring), C bit for bit the fault-free
   C, fewer ops recomputed than a full replay; three passes at n=4096
   (``FAULTS_PASSES_N``) with per-rank
   ``Workflow.checkpoint`` barriers after the first and rank 1 killed at
   the last boundary, on ``serial`` and on ``procs`` (a transient
   ``SIGKILL``: the worker respawned): the barriers' C tiles read back
   from disk, fewer ops recomputed than without, the same counts on both;
8c. the serving runtime (``repro_torch.serve.ServingRuntime``) on
   ``serial``, ``fused`` and ``threads``, each with ``max_batch`` 1 and 8,
   cold then warm: 8 lock-step client threads (``bench_serving.py``'s
   shape), each one init request and 6 step requests on CUDA tensors: a
   ``gemm_tile`` on its 1024^2 f32 C tile (A and B shared: the GEMM), an
   ``attn_step`` on its 512 x 128 carry with fresh 512-key k and v made
   by the client thread (``chain_attn``, one level, on ``f32_3xtf32``:
   its 512 keys in 4 chunks, 16 blocks) and the decode step
   ``x * 0.99 + 0.5`` on a 1024^2 state; every session's C, carry and
   state bitwise what the same steps give recorded into one workflow on
   a ``serial`` executor, 48 GEMM and 48 ``chain_attn`` launches and no
   other, 56 requests completed, requests coalesced under ``max_batch``
   8 (and then, under ``fused``, ops fused), the device memory given back after
   ``close()``; printed: requests/s, the runtime's p50/p99 (time to
   enqueue: a future resolves when the kernels are enqueued), the
   clients' p50/p99 to a host copy of the result, and the busy share of
   one more warm run under ``torch.profiler``; per backend, quickstart
   section 11 on CUDA payloads (the third submission shed, the poison
   pill poisons only its session, bisection salvages the other request)
   and ``bench_serving.py``'s steady state (100 steps, the trace bounded
   by ``compact_threshold`` 12, compactions above 0, bitwise 100 eager
   steps);
8d. MapReduce: ``sort_integers`` on 2^26 uniform 31-bit int64 held as one
   CUDA tensor at 1, 4 and 8 nodes under ``serial`` and ``fused``: equal to
   ``torch.sort``, on the card, no kernel wrapper launched, the memory
   given back; the wall, the shuffle's bytes and messages, and the busy
   share printed; and ``examples/mapreduce_sort.py``'s 2,000,000 values
   as a NumPy array on the host, equal to ``np.sort``;
8e. the LM stack (``[lm]``, :func:`lm_phase`): RecurrentGemma-9B at its
   published widths and depth (38 layers, d_model 4096, 16 heads over 1,
   head_dim 256, d_ff 12288, lru_width 4096, window 2048, vocab 256000),
   bf16, its 9,395,666,944 weight-matrix parameters (``count_params``)
   drawn on the card from a seeded ``torch.Generator``; served through
   ``make_prefill_step`` / ``make_decode_step``: 2 prompts of 4096 tokens,
   then 32 greedy decode steps, cold then warm; the warm run with every
   count zeroed just before: exactly 12 ``flash_attention`` launches on
   ``bf16_wgmma`` and 26 ``linear_scan`` launches on ``tma``, no other
   kernel wrapper, no call of either plain version (counted by wrappers
   installed here), the operands handed to the entry points and how many
   a row-major copy takes; the profile of a prefill shows the two kernels
   by name (12 and 26), and where the device time goes (cuBLAS GEMMs,
   flash attention, the scan, copies, the rest) for prefill and decode,
   with the busy shares; prefill and decode walls, tokens/s and their
   bounds (prefill's FLOPs at the bf16 peak, a decode step's weight bytes
   at the HBM rate); every kernel call of one more prefill held against its
   plain version (attention within 3e-2 and ``half_attention_error``'s
   limits, the scan bit for bit ``ref.linear_scan_chunked`` and within
   2e-5 of the sequential oracle); the device memory given back; then
   the reference's serving check in float32 at 5 layers (one pattern
   period and the tail): a 3072-token prefill (past the window) and 8
   teacher-forced decode steps, each step's logits within 2e-3 of the
   full-sequence forward's;
8f. training (``[train]``, :func:`train_phase`): RecurrentGemma-9B at its
   published widths with the depth cut to one pattern period (3 layers:
   rglru, rglru, local_attn; 1,705,017,344 weight-matrix parameters), bf16,
   random weights from a seed, the reference's AdamW under
   ``warmup_cosine``, B 1 x S 4096 from ``SyntheticLMDataset``, remat on,
   10 steps through ``make_train_step``: every loss and grad norm finite,
   the last three losses' mean below the first, every parameter a finite
   non-zero gradient at step 1; with every count zeroed before the first
   step, exactly 2 ``flash_attention`` (``bf16_wgmma``, each handing the
   backward its log-sum-exp), 1 ``flash_attention_bwd`` (``bf16_wgmma``)
   and 6 ``linear_scan`` (``tma``; 4 forward, 2 backward) launches a step,
   no other kernel wrapper, no plain version called; step 1's attention
   backward held to its plain version in float32 (rms error per head
   slice <= 2^-7 of the plain version's) and its 6 scan launches bit for
   bit
   ``ref.linear_scan_chunked``; the warm step wall (median of steps
   3-10), tokens/s, model FLOP/s against the bf16 peak, the bound (6 N T
   at 989 TFLOP/s plus the optimizer's bytes at 3.35 TB/s), peak memory,
   and one more step under the profiler (busy share; device time by class:
   cuBLAS GEMMs, attention forward and backward, scan, copies, the
   optimizer by CUDA events, the rest); a float32 step through the kernels
   (attention on ``f32_3xtf32`` both ways) against the same step on the
   plain versions on the card (loss and every gradient within 1e-3 of its
   largest value), timed; the attention backward at RecurrentGemma-9B's
   training shape (bf16, f32, f16), Qwen3-14B's width (bf16, f32, f16),
   h2o-danube-1.8b's and Gemma-7B's (f32), in bf16 and f16 on both routes
   (``bf16_wgmma`` / ``f16_wgmma`` with the forward's log-sum-exp,
   ``bf16_simt`` / ``f16_simt`` forced by a view at an odd offset),
   against its plain version and against a second call of itself (bit for
   bit: no atomics), timed beside its bound, the plain version and SDPA's
   backward (a yardstick the port never calls), each tensor-core route
   required faster than both the plain version and its CUDA-core route;
   f16's overflow case (|dS| past 65504: ``f16_wgmma``'s dq and dk not
   finite where ``f16_simt``'s are, a pinned divergence); the memory
   given back;
8g. the rest of the LM stack, served (``[lm_moe]``,
   :func:`lm_moe_phase`): granite-moe-3b-a800m at its published widths and
   depth (32 layers, d_model 1536, 24 heads over 8, head_dim 64, 40
   experts top-8, expert d_ff 512, vocab 49155, tied), bf16 with float32
   routers, its 3,298,693,632 weight-matrix parameters (882,774,528 active
   a token) drawn on the card from a seed; 2 prompts of 4096 tokens and 32
   greedy decode steps through ``make_prefill_step`` / ``make_decode_step``,
   cold then warm: exactly 32 ``flash_attention`` launches on
   ``bf16_wgmma`` a prefill, no other kernel wrapper, no plain version
   called, two served runs the same tokens (the MoE combine has no
   atomics); walls, tokens/s and bounds (prefill: active weights' FLOPs
   plus attention's at 989 TFLOP/s; a decode step: every weight byte at
   3.35 TB/s); the profile of a prefill and of 8 decode steps by class,
   the MoE's routing, dispatch, expert FFN and combine apart (profiler
   ranges around them); peak memory; every attention call of one more
   prefill held to its plain version with the bf16 limits, the balance
   loss of each layer finite and positive, the (token, slot) pairs each
   layer's capacity drops; the memory given back; the reference's serving
   check in float32 at 2 layers with a capacity that drops no token;
8h. the other four families (``[lm_families]``,
   :func:`lm_families_phase`), bf16 at their published widths, each 2
   prompts and 8 decode steps, cold then warm: Moonshot-v1-16b-a3b (64
   experts top-6, MHA at d 128; depth cut to 4 of 48 layers, its 28.06 B
   parameters being 56 GB), Seamless-m4t-medium (12 encoder layers over 2 x
   1024 frames, 12 decoder layers over 2 x 4096 tokens with
   cross-attention: 12 + 12 + 12 launches, the cross-attention non-causal
   with 4096 queries over 1024 keys), Phi-3-vision-4.2b (64 patches + 4032
   tokens, d 96 on ``bf16_wgmma``, 32 launches) and xLSTM-350m (6 of its 24
   mLSTM / sLSTM layers, 3 whole pattern periods: its sLSTM loop is
   host-bound, no kernel; the loop timed a token a layer with CUDA
   events); launches by route, two served runs the same tokens,
   every attention call of one more prefill held to its plain version;
   walls, rates, peak memory, the memory given back, and each family's
   float32 serving check at 2 layers;
8i. training the five (``[train_families]``, :func:`train_families_phase`)
   at their published widths, two layers (Seamless one encoder and one
   decoder layer), bf16, B 1 x S 2048, remat, 3 AdamW steps (xLSTM 2):
   losses finite, every parameter a finite non-zero gradient at step 1, the
   attention forward and backward launches by route every step, step 1's
   attention backwards (Seamless's non-causal cross-attention with Sq 2048
   over Skv 512 among them) within 2^-7 rms per head slice of
   ``ref.attention_grad``, the memory given back; Gemma-7B at its
   published widths in float32 (2 of 28 layers, B 1 x S 4096): step 1's
   loss and every gradient within 1e-3 of the same step on the plain
   versions, 3 AdamW steps through ``make_train_step`` (4 attention
   forwards and 2 backwards a step, all ``f32_3xtf32``), step walls,
   model FLOP/s, peak memory, one step profiled; then attention at the
   families' shapes (:func:`family_attention_timed`: Granite's 24 over 8
   at d 64, Seamless's cross-attention 4096 over 1024 non-causal,
   Phi-3-vision's 32 over 32 at d 96 and h2o-danube's 32 over 8 at d 80),
   forward and backward, each held to its plain version and timed beside
   its bound, the plain version and SDPA's, and at d 80 and 96 beside
   ``bf16_simt`` (views at an odd offset), which it must beat; the same
   in f16 at d 64, 80 and 96 on ``f16_wgmma`` (its forward beside
   ``f16_simt``);
8j. training that checkpoints (``[train_ckpt]``, :func:`train_ckpt_phase`):
   granite-moe-3b-a800m at its published widths, 2 layers, bf16, B 1 x S
   2048, 4 AdamW steps saving parameters and optimizer state through
   ``CheckpointManager`` after step 1 (3.9 GB; the host snapshot, write and
   restore seconds and the bytes printed), a model from another seed
   restoring it and taking steps 3-4 to the same losses (within 1e-5,
   bit for bit printed), the attention launches by route; then
   ``gemma_7b --reduced`` (the reference test's arguments) on the card
   under the ``Supervisor``: a run that crashes at step 25 (exit 42), a
   second supervisor that resumes it from step 19 to the final loss of an
   uninterrupted run (relative 1e-5);
8k. the LM on rank meshes (``[lm_mesh]``, :func:`lm_mesh_phase`), the
   ranks sharing the card: explicit data parallelism on h2o-danube-1.8b at
   its published widths, 2 layers, float32, 8 x 1024 tokens, 3 AdamW steps
   through ``make_manual_dp_train_step`` with the ``tree`` and ``ring``
   schedules on 4 ranks and ``hierarchical`` with and without the int8
   pod hop on (2, 2) ranks, each held to ``make_train_step`` on the card
   with the reference self-test's bounds (2e-4; int8 5e-2 / 5e-3), every
   rank's replica, masters and moments bit for bit rank 0's after every
   step, every step's copies and bytes the schedule's closed-form count
   (``launch/meter_gradsync.py``), 8 ``flash_attention`` and 8
   ``flash_attention_bwd`` launches a step on ``f32_3xtf32`` (DP_ROUTE), no
   plain version; the warm step wall, busy share, copies and GiB a step; then
   Moonshot's expert parallelism at its published widths, 4 layers, bf16:
   a 2 x 4096 prefill under ``make_policy(make_host_mesh(1, 4))`` (16
   experts a rank, two ``all_to_all`` a layer) with 4 ``bf16_wgmma``
   launches, held to the same prefill in ``moe_mode="replicated"`` within
   the bf16 limits, timed beside it and beside a prefill without a
   policy, its copies and bytes; 8 decode steps under a policy with
   ``seq_sharded=False``; the loss's gradient at 2 layers, B 1 x S 2048,
   every expert weight a finite non-zero gradient, within 2e-2 of each
   leaf's largest value of replicated mode's; the memory given back (the
   prefill and decode steps there split the whole weights every call);
   then the policy's ``make_train_step`` with parameters, masters and
   moments at rest as per-rank shards on (2, 2) ranks: at danube's 2
   layers held to the policy-free step (bit for bit, printed), at its
   published 24 layers (which four DP replicas with AdamW state could not
   hold) with its wall, model FLOP/s, busy share, peak memory and
   resident bytes a rank; each with its copies, bytes and resident bytes
   the closed form, 2 forward and 1 backward ``f32_3xtf32`` launches a
   layer a step; the Moonshot prefill again with the weights at rest
   (the experts on the expert axis): logits bit for bit, the expert
   splits gone, splits and copies the closed form; 8 decode steps with
   the weights TP-sharded at rest within the bf16 limits of decode
   without a policy; then ``selftest_train_dp``, ``selftest_elastic`` and
   ``meter_gradsync`` with ``--device cuda``;
9. a ``kernels`` JSON line (every ported kernel with its launches on its
   path and its times; the GEMM's accumulate and ``chain_attn`` also with
   their launches in one serving arm, ``flash_attention`` and
   ``linear_scan`` with their launches, route and mean device time in one
   ``[lm]`` prefill and their launches in one ``[train]`` step; the
   attention backward with its launches over ``[train]``'s 10 steps, its
   times at RecurrentGemma-9B's training shape and each bf16 route's time
   at both widths; ``flash_attention`` also with each family's launches
   and routes a prefill, its device time inside the Granite prefill and
   its times at the families' shapes, the backward with each family's
   launches a training step and its times there; the GEMM also with its
   launches an iteration inside the ``procs`` workers, the ``procs`` and
   ``serial`` walls and the ops each fault recomputed; the GEMM and
   ``chain_ewise`` / ``chain_dot`` rows also with their launches on the
   armed rank mesh, ``mesh_launches``, and the GEMM row with the mesh's
   ships, copies, walls and the shard_map GEMM's times; ``flash_attention``
   and its backward also with their launches by route in one ``[lm_mesh]``
   DP step, one expert-parallel prefill and its gradient, under
   ``lm_mesh``), the script's time
   (each LM phase prints its own as it ends), the card's name and power limit, and, last, ``{"ok": true, "device":
   {...}}``.

It exits non-zero, printing no result, when CUDA is unavailable or when the
port's sources are not beside it.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_LISTING = 8192          # Listing 1 / Strassen matrix size
IB = 1024                 # tile size: the leaf GEMM is IB^3
SCAN_LEVELS = 64          # scan_step chain depth (bench_dag_overhead.py)
DOT_LEVELS = 8            # gemm_tile chain depth: one C tile of Listing 1
ATTN_TILE = (512, 512, 128, 128)   # attn_step chain: m, n, d, dv (Qwen3-14B)
ATTN_LEVELS = 16
SEED = 0
# the serving phase: bench_serving.py's full shape (sessions, steps), each
# step one GEMM (a Listing 1 tile), one chain_attn level and a decode step
SERVE_SESSIONS, SERVE_STEPS = 8, 6
SERVE_KERNELS = {"gemm_tf32_kernel": SERVE_SESSIONS * SERVE_STEPS,
                 "chain_attn_tf32_kernel": SERVE_SESSIONS * SERVE_STEPS}
# the MapReduce phase: 2^26 uniform 31-bit int64 (512 MiB) on the card, the
# example's 2,000,000 on the host
SORT_N = 1 << 26
SORT_HOST_N = 2_000_000
SORT_NODES = (1, 4, 8)
# rounds of the threads-vs-serial bar (phase 8): both sides run the same
# serial loop on card operands, so the median of the rounds' ratios must
# sample past the host's noise (a one-card machine shares its host's
# cores); 80 since the 3xTF32 GEMM left Listing 1 host-bound (best of 40:
# serial 0.0443 s, threads 0.0493 in one run on an H100, where the threads
# backend adds only a pass over the plan's inputs to the same serial loop)
THREADS_ROUNDS = 80
# the GEMM's kernels, one per tile loop (kernels/gemm/csrc/gemm.cu)
GEMM_KERNELS = ("gemm_simt_kernel", "gemm_wgmma_kernel", "gemm_dmma_kernel",
                "gemm_tf32_kernel")
# the route and kernel of every float32 GEMM on the main path (Listing 1,
# Strassen, procs, the armed mesh, served gemm_tile, gemm_tile chains):
# aligned 1024^2 tiles take the tensor cores in 3xTF32, never f32_simt
F32_ROUTE = "f32_3xtf32"
F32_KERNEL = "gemm_tf32_kernel"
# the 3xTF32 GEMM's tensor-core instruction in the SASS
TF32_HGMMA = "HGMMA.64x64x8.F32.TF32"
# the mangled element type of the 16-bit tensor-core kernels'
# instantiations (flash_attention_wgmma_kernel<D, T>,
# attention_bwd_*_wgmma_kernel<D, T>, gemm_wgmma_kernel<T, O>,
# chain_dot_wgmma_kernel<T>, chain_attn_wgmma_kernel<T, D>)
HALF_MANGLED = {"bf16": "13__nv_bfloat16", "f16": "6__half"}
# chain_attn's route at ATTN_TILE (aligned, d = dv = 128) by dtype, and
# its CUDA-core route (taken by odd-offset copies of the same values)
CHAIN_ATTN_ROUTES = {"float32": ("f32_3xtf32", "f32_simt"),
                     "bfloat16": ("bf16_wgmma", "bf16_simt"),
                     "float16": ("f16_wgmma", "f16_simt"),
                     "float64": ("f64_simt", "f64_simt")}
# chain_attn's 16-bit tensor-core routes: their largest error against a
# float64 computation at most this many times the CUDA-core loop's on the
# same values.  P is rounded to bf16 / f16 before P V, which moves a level
# by at most u max|v| (u the type's unit roundoff), the same size as the
# output's own rounding to the type that both routes make and independent
# of it: about sqrt(2) in rms, 1.5x at the largest, where the carry starts
# at 0, and 1x where a carry of unit size dominates
# (kernels/chain/csrc/chain_attn_tc.cuh).  P rounded through bf16 on f16
# (4u) falls outside it (tools/attn_faults.py)
CHAIN_HALF_VS_SIMT = 2.0

# flash attention: the reference's cases (tests/test_kernels.py:75-82,
# padded with bq = bkv = 16) as (B, Hq, Hkv, Sq, Skv, D, causal, window)
ATTN_CASES = ((1, 2, 2, 32, 32, 8, True, None),
              (2, 4, 2, 64, 64, 16, True, None),
              (1, 8, 1, 32, 32, 16, True, None),
              (1, 2, 2, 64, 64, 8, True, 16),
              (1, 2, 1, 48, 48, 8, False, None),
              (1, 2, 2, 33, 33, 8, True, None))
# full width, causal, one sequence of 8192 (src/repro/configs/*.py):
# (B, Hq, Hkv, S, D, window)
FULL_ATTN = {"RecurrentGemma-9B": (1, 16, 1, 8192, 256, 2048),
             "Qwen3-14B": (1, 40, 8, 8192, 128, None),
             # Gemma-7B's training shape (16 / 16 heads at d 256, causal)
             "Gemma-7B": (1, 16, 16, 4096, 256, None)}
ODD_ATTN = ("h2o-danube-1.8b", (1, 32, 8, 1024, 80, 4096))
# the full widths that also run in float16 (f16_wgmma, and f16_simt on
# the same values one element into their storage)
FULL_ATTN_F16 = ("RecurrentGemma-9B", "Qwen3-14B")
# the reference's tolerances (tests/test_kernels.py): rtol = atol; the
# reference has none for float16: its output is rounded once to 11 bits
# (2^-11 relative) from fp32 sums in another order than the plain
# version's, and 1e-2 is twenty such roundings
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2, "float16": 1e-2}
# bf16 cases with many key tiles per query tile, at every head dim the
# tensor-core route takes: its ring refills and barrier phases, O
# rescales, causal and window tile bounds, and ragged last tiles (Skv 1000
# and 777 are no multiple of its 128- or 64-key tiles), causal or not;
# (B, Hq, Hkv, Sq, Skv, causal, window, bq = bkv)
MID_ATTN = ((1, 4, 2, 1024, 1024, True, None, 512),
            (1, 4, 1, 1024, 1024, True, 300, 512),
            (1, 2, 2, 1000, 1000, True, None, 8),
            (1, 2, 2, 512, 1000, False, None, 8),
            (1, 2, 1, 777, 777, False, 200, 7))
MID_HEAD_DIMS = (64, 80, 96, 128, 192, 256)
# bfloat16 attention against the float32 oracle on the same inputs, to
# limits scaled to each value (half_attention_error).  The output is
# rounded once to bf16: at most 2^-8 |exp| off.  The tensor-core route
# also rounds each weight p in [0, 1] to bf16 before P V: at most 2^-8 p
# off, so an element at most 2^-8 max|v| off (the weights sum to one).
# The per-element limit is the sum of the two.  Both errors are unbiased,
# so their root mean square is far below: over exp's, about 2.1e-3 for a
# (batch, head) slice and at most 3.5e-3 for one row, in a float64 model of
# the kernel's rounding (S 1024-4096, d 64-256); the limits are 2^-7 and
# 2^-6, where a fault that moves a row by a few percent shows.
BF16_ELEMENT = 2.0 ** -8
BF16_SLICE_NRMS = 2.0 ** -7
BF16_ROW_NRMS = 2.0 ** -6
# float16 (f16_wgmma) by the same derivation with f16's unit roundoff u =
# 2^-11 in place of bf16's 2^-8: the output rounded once, at most 2^-11
# |exp| off, and each weight p rounded to f16 before P V, at most 2^-11 p
# off where p is normal (2^-14 and up) and at most 2^-25 absolute below
# (f16's subnormals, which bf16 does not have), so an element at most
# (2^-11 + Skv 2^-25) max|v| off for a row of Skv keys.  The per-element
# limit is the sum, 2^-11 (|exp| + max|v|) + F16_SUBNORMAL Skv max|v|; the
# rms limits are bf16's multiples of u, 2u a slice and 4u a row (2^-10 and
# 2^-9), eight times tighter.  In the float64 model above scaled to f16 the
# rms sits near 3e-4 a slice; with P rounded through bf16 first (2^-8 p
# off: the fault tools/attn_faults.py plants) near 1.7e-3, above 2^-10.
# The backward is held to F16_SLICE_NRMS rms per head slice of the plain
# version in float32, as bf16's is to BF16_SLICE_NRMS.
F16_ELEMENT = 2.0 ** -11
F16_SUBNORMAL = 2.0 ** -25
F16_SLICE_NRMS = 2.0 ** -10
F16_ROW_NRMS = 2.0 ** -9
# each 16-bit dtype's limits: (element, subnormal, slice rms, row rms)
HALF_LIMITS = {"bfloat16": (BF16_ELEMENT, 0.0, BF16_SLICE_NRMS,
                            BF16_ROW_NRMS),
               "float16": (F16_ELEMENT, F16_SUBNORMAL, F16_SLICE_NRMS,
                           F16_ROW_NRMS)}
# linear scan: the reference's shapes (tests/test_kernels.py:129) and
# RecurrentGemma-9B's RG-LRU (B, S, lru_width); f32 at the property test's
# bound for any block size, bf16 at the reference's
SCAN_SHAPES = ((1, 16, 4), (2, 64, 8), (3, 100, 5), (1, 256, 16))
# many 128-step chunks with a short last one: an odd D (every route's
# ragged slab), and three sequences whose last slab is part full
LONG_SCANS = ((2, 1000, 33), (3, 4000, 160))
FULL_SCAN = (1, 8192, 4096)
SCAN_SEEDS = 8            # seeds over which the kernel-vs-loop reading runs


def scan_rounding_bound(s: int, c: int) -> float:
    """The worst case of float32 rounding along the chunked scan of ``s``
    steps in chunks of ``c``, a factor of the largest |value| met (|a| <=
    1): each step rounds twice (u = 2^-24 each); step 1's aggregates carry
    2c steps' rounding into each of step 2's s / c carries, whose products
    of c factors add c more; step 3 adds 2c: u (3s + 2s / c + 2c) <= 4u (s
    + c)."""
    return 4 * (s + c) * 2.0 ** -24


# float16 as float32 inside, rounded once to 11 bits: as ATTN_TOL's
SCAN_TOL = {"float32": 2e-5, "bfloat16": 4e-2, "float16": 1e-2}

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W):
# HBM 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s; bfloat16
# tensor cores 989 TFLOP/s; float64 tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float64": 67e12,
              "float16": 989e12, "tf32": 495e12}
# f32_3xtf32 runs three TF32 products for every float32 one: its bound is
# 3x the work at the TF32 rate, where f32_simt's is 1x at 67 TFLOP/s
TF32_PRODUCTS = 3
# f32_3xtf32's largest error against a float64 computation, at most this
# many times f32_simt's on the same inputs
TF32_VS_SIMT = 4.0
# f16_wgmma's largest error against the float64 product of the same
# float16 inputs, at most this many times f16_simt's on the same values,
# by output type: a float16 output is one rounding of either route's
# float32 sum, so the two are nearly equal (1.25); a float32 output is the
# sum itself, which the tensor cores add in another order than f16_simt's
# chain of FMAs (4, as TF32_VS_SIMT)
F16_VS_SIMT = {"float16": 1.25, "float32": 4.0}
# Listing 1 in float16 (n N_LISTING, ib IB): C's relative Frobenius error
# against the float64 product of the same float16 inputs.  Each of a C
# tile's 8 partial products is a float32 sum rounded once to float16
# (2^-11 relative, ~2^-11 / sqrt(3) rms), and the reduction's 7 float16
# adds round the carry again: ~6-8e-4 in all; the limit is about 2.5-3x it
F16_LISTING_REL = 2e-3
# (m, k, n) of the GEMM's f32_3xtf32 checks against float64 past the leaf:
# K 8192 (DOT_LEVELS levels of 1024 in one sum), ragged M and N, K % 8 ==
# 4 (a last k8 step of 4), a single row
TF32_SHAPES = ((1024, 8192, 1024), (130, 72, 264), (130, 68, 260),
               (200, 1028, 132), (1, 1024, 68))
# shapes held to the plain version and to themselves (two calls), whose
# float64 errors are printed but not held to TF32_VS_SIMT: at K 4 either
# route's error is a float32 ulp or two on four values (3xTF32's floor is
# its dropped lo.lo term, 2^-22 relative, which a chain of 4 IEEE FMAs
# can beat by luck: 2.3e-7 against 2.0e-8 on an H100), so the ratio of
# the two maxima measures nothing
TF32_TINY = ((1, 4, 4), (64, 4, 64))
# (operand, element, float32 bits) of the GEMM's non-finite check: NaNs
# (CUDA's canonical one, its negative, torch's and its negative) and
# infinities of both signs, two of them in row 9 of a.  A signalling NaN
# with nothing in its top 10 mantissa bits is left out: TF32 keeps only
# those bits, so f32_3xtf32 reads it as +-inf
NON_FINITE = (("a", (3, 5), 0x7FFFFFFF), ("a", (100, 700), -1),
              ("a", (500, 0), 0x7FC00000), ("a", (7, 1023), 0x7F800000),
              ("a", (8, 40), -0x800000), ("a", (9, 41), 0x7F800000),
              ("a", (9, 42), 0x7F800000), ("b", (9, 200), -0x800000),
              ("b", (600, 64), 0x7F800000), ("b", (1000, 1000), -0x400000),
              ("b", (1023, 500), -0x800000))
# kernel vs plain version: (rtol, atol) per dtype.  float32 and bfloat16 are
# the reference's GEMM contract (tests/test_kernels.py); the two versions sum
# in different orders.  float64 sums of 1024 unit-variance products carry
# errors near 1e-13.
TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 2e-1),
       "float64": (1e-10, 1e-9), "float16": (1e-2, 1e-2)}


# the GEMM's output tolerance (out_dtype): the TOL of the less precise of
# the accumulator's type (float32, float64 for float64 inputs) and the
# output type, so a float32 output of bfloat16 inputs is held at float32's
PRECISION = ("bfloat16", "float16", "float32", "float64")


def out_tolerance(din: str, dout: str) -> tuple:
    acc = "float64" if din == "float64" else "float32"
    return TOL[min(acc, dout, key=PRECISION.index)]


def nearest_even(torch, x, dtype):
    """``x`` rounded once to nearest even in ``dtype``: torch's cast, save
    float64 -> bfloat16 / float16 (which torch takes through float32),
    rounded here to the narrow type's step at each element's exponent."""
    if x.dtype != torch.float64 or dtype not in (torch.bfloat16,
                                                 torch.float16):
        return x.to(dtype)
    bits_, emin = (8, -133) if dtype == torch.bfloat16 else (11, -24)
    _, e = torch.frexp(x)
    step = torch.ldexp(torch.ones_like(x), (e - bits_).clamp_min(emin))
    return (torch.round(x / step) * step).to(dtype)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def gpu_clocks() -> str:
    """The card's SM and memory clocks now, as ``nvidia-smi`` reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
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


def graph_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed: back to back on the card, with no host time
    between launches (for kernels that take less time than their
    wrapper's host work per call)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (2 * iters)


def attention64(torch, fa_ref, q, k, v, causal, window, heads=None):
    """float64 attention of the query heads ``heads`` (all by default) of
    ``q`` over ``k``, ``v`` (the port's ``flash_attention.ref`` masks):
    the yardstick of the f32_3xtf32 route's accuracy."""
    b, hq, sq, d = q.shape
    group = hq // k.shape[1]
    seen = fa_ref.mask(sq, k.shape[2], causal=causal, window=window,
                       device=q.device)
    any_seen = seen.any(dim=-1, keepdim=True)
    heads = range(hq) if heads is None else heads
    out = torch.empty((b, len(heads), sq, d), dtype=torch.float64,
                      device=q.device)
    for bi in range(b):
        for i, h in enumerate(heads):
            sc = (q[bi, h].double() @ k[bi, h // group].double().T
                  ) * d ** -0.5
            sc = torch.where(seen, sc, -1e300)
            p = torch.where(any_seen, torch.softmax(sc, dim=-1), 0.0)
            out[bi, i] = p @ v[bi, h // group].double()
    return out


def attention_grad64(torch, fa_ref, q, k, v, dout, causal, window):
    """float64 (dq, dk, dv) of attention of ``q`` over ``k``, ``v`` for the
    output gradient ``dout`` (the port's ``flash_attention.ref`` masks and
    its ``attention_grad``'s arithmetic, each product in float64): the
    yardstick of the f32_3xtf32 backward's accuracy."""
    b, hq, sq, d = q.shape
    group = hq // k.shape[1]
    seen = fa_ref.mask(sq, k.shape[2], causal=causal, window=window,
                       device=q.device)
    any_seen = seen.any(dim=-1, keepdim=True)
    f64 = torch.float64
    dq = torch.empty(q.shape, dtype=f64, device=q.device)
    dk = torch.zeros(k.shape, dtype=f64, device=q.device)
    dv = torch.zeros(v.shape, dtype=f64, device=q.device)
    for bi in range(b):
        for h in range(hq):
            qq, g = q[bi, h].double(), dout[bi, h].double()
            kk, vv = k[bi, h // group].double(), v[bi, h // group].double()
            sc = torch.where(seen, (qq @ kk.T) * d ** -0.5, -1e300)
            p = torch.where(any_seen, torch.softmax(sc, dim=-1), 0.0)
            dp = g @ vv.T
            ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
            ds = torch.where(seen, ds, 0.0) * d ** -0.5
            dq[bi, h] = ds @ kk
            dk[bi, h // group] += ds.T @ qq
            dv[bi, h // group] += p.T @ g
    return dq, dk, dv


def chain_attn64(torch, layout, n_levels, o, q, k, v):
    """A chain of ``attn_step`` levels in float64, no rounding between
    levels: what ``chain_attn``'s routes are held to (each ``"xs"``
    operand's level sliced, the others shared)."""
    acc = o.double()
    scale = 1.0 / q.shape[-1] ** 0.5
    for lv in range(n_levels):
        qq, kk, vv = ((t[lv] if lay == "xs" else t).double()
                      for lay, t in zip(layout[1:], (q, k, v)))
        acc = acc + torch.softmax(qq @ kk.T * scale, -1) @ vv
    return acc


def tf32_vs_simt(got, simt, exact, heads: int = 8) -> float:
    """The largest ratio, over slices of at most ``heads`` heads (dim 1),
    of ``got``'s largest |error| against ``exact`` (float64) to
    ``simt``'s (the f32_simt route's on the same inputs): at most
    TF32_VS_SIMT for an f32_3xtf32 result."""
    worst = 0.0
    for h0 in range(0, got.shape[1], heads):
        sl = slice(h0, h0 + heads)
        e = (got[:, sl].double() - exact[:, sl]).abs().max().item()
        base = (simt[:, sl].double() - exact[:, sl]).abs().max().item()
        worst = max(worst, e / max(base, 1e-30))
    return worst


def half_attention_error(got, exp32, v) -> dict:
    """How far the 16-bit (bfloat16 or float16) attention output ``got``
    (B, H, S, D) lies from the float32 oracle ``exp32`` on the same
    inputs, with ``v`` (B, Hkv, Skv, D) the values: ``element`` (the
    largest error over its limit, ELEMENT (|exp| + max|v|) + SUBNORMAL Skv
    max|v| of its dtype's HALF_LIMITS), ``slice`` and ``row`` (the largest
    root-mean-square error of a (batch, head) slice and of a row over
    exp's there; rows that see no key are left out).  Within the limits
    (:func:`half_within`) when ``element <= 1`` and the rms errors are
    within the dtype's slice and row limits."""
    dname = str(got.dtype).removeprefix("torch.")
    element, subnormal = HALF_LIMITS[dname][:2]
    exp = exp32.double()
    err = got.double() - exp
    vmax = v.abs().max().double()
    limit = element * (exp.abs() + vmax) + subnormal * v.shape[2] * vmax
    element = (err.abs() / limit.clamp_min(1e-300)).max().item()
    e2, x2 = err.square(), exp.square()
    slices = (e2.sum((2, 3)) / x2.sum((2, 3)).clamp_min(1e-300)).sqrt()
    rows = x2.sum(-1)
    seen = rows > 0
    row = ((e2.sum(-1)[seen] / rows[seen]).sqrt().max().item()
           if bool(seen.any()) else 0.0)
    return {"element": element, "slice": slices.max().item(), "row": row}


def half_within(stats: dict, dname: str) -> bool:
    """Whether :func:`half_attention_error`'s ``stats`` of a ``dname``
    output are within that dtype's HALF_LIMITS."""
    _, _, slice_nrms_, row_nrms = HALF_LIMITS[dname]
    return (stats["element"] <= 1.0 and stats["slice"] <= slice_nrms_
            and stats["row"] <= row_nrms)


def bound_ms(nbytes: int, flops: int, dtype: str) -> tuple[float, str]:
    """Least time for the work: the larger of bytes over HBM rate and
    operations over the dtype's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def held_blocks(torch) -> list:
    """The sizes of the largest device allocations still live (for a
    failure message)."""
    sizes = sorted((blk["size"] for seg in torch.cuda.memory_snapshot()
                    for blk in seg["blocks"]
                    if blk["state"] == "active_allocated"), reverse=True)
    return sizes[:8]


def visible_pairs(s: int, window) -> int:
    """(row, key) pairs causal attention over one sequence of ``s`` sees:
    row r sees min(r + 1, window) keys."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


# spin kernels that open and close every profiled window (device_profile)
PROFILE_PAD = 64


def device_profile(torch, label: str, run, wall_s: float,
                   expect: dict, found: dict | None = None) -> float:
    """Run ``run`` once more under ``torch.profiler`` and print where the
    device time goes: kernel time by name, and the device's busy share of
    the unprofiled warm wall time ``wall_s``.  ``expect`` maps a kernel
    name to the number of its launches the card must show: the card ran
    the hand-written kernels, not something in their place.  Returns the
    busy share in percent; ``found``, when given, gets each expected
    name's ``(ms, launches)``, the device time in all (``"total"``) and
    every kernel's ``(ms, launches, name)`` (``"kernels"``)."""
    from torch.profiler import ProfilerActivity, profile

    attempts = 8
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # spin kernels (PROFILE_PAD, left out of every number below)
            # and a pause on both sides of the run: traces of a run of a
            # millisecond with one or two kernels came back empty now and
            # then, with a tail alone too (every attempt of one process)
            for pad in ("head", "tail"):
                if pad == "tail":
                    run()
                    torch.cuda.synchronize()
                for _ in range(PROFILE_PAD):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
                time.sleep(0.02)
        spins = sum(e.count for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "spin_kernel" in e.key)
        kernels = sorted(
            ((e.self_device_time_total / 1e3, e.count, e.key)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.self_device_time_total > 0
             and "spin_kernel" not in e.key),
            reverse=True)
        seen = {name: sum(cnt for _ms, cnt, key in kernels if name in key)
                for name in expect}
        if kernels and seen == expect:
            break
        # the tracer drops activity records now and then (a whole trace,
        # or the first kernel of a run whose launches were counted and
        # whose result was right): trace the run again; the checks below
        # fail if no trace shows exactly the counted launches
        print(f"[profile] {label}: the trace shows {seen} among "
              f"{sum(n for _ms, n, _k in kernels)} kernel launches and "
              f"{spins} of the {2 * PROFILE_PAD} spin kernels, expected "
              f"{expect} (attempt {attempt + 1} of {attempts})")
    for ms, cnt, key in kernels[:6]:
        print(f"[profile] {label}:   {ms:9.3f} ms {cnt:5d}x {key[:90]}")
    total = sum(ms for ms, _n, _k in kernels)
    busy = 100 * total / (wall_s * 1e3)
    parts = []
    for name, want in expect.items():
        hits = [(ms, cnt) for ms, cnt, key in kernels if name in key]
        got_ms = sum(ms for ms, _ in hits)
        got_n = sum(cnt for _, cnt in hits)
        check(got_n == want, f"{label}: profiler saw {got_n} {name} "
              f"launches, expected {want}")
        if found is not None:
            found[name] = (got_ms, got_n)
        if got_n:
            parts.append(f"{name} {got_n} launches {got_ms:.3f} ms (mean "
                         f"{got_ms / got_n:.4f} ms, "
                         f"{100 * got_ms / total:.1f}% of device time)")
        else:
            parts.append(f"{name} 0 launches")
    if found is not None:
        found["total"] = total
        found["kernels"] = kernels
    print(f"[profile] {label} warm: device kernel time {total:.3f} ms of "
          f"{wall_s * 1e3:.3f} ms wall (busy {busy:.1f}%); "
          + "; ".join(parts))
    return busy


def memory_back(torch, dev, base: int, label: str) -> None:
    """Collect, then check the device memory allocated above ``base`` is
    back under 4 MiB."""
    gc.collect()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated(dev) - base
    check(left < 4 << 20, f"{label}: {left} bytes still allocated "
          f"(largest blocks {held_blocks(torch)})")
    print(f"{label}: device memory held after it: {left} bytes")


def memory_base(torch, dev) -> int:
    """The device memory allocated now, taken as a phase's baseline once
    cuBLAS holds its workspaces: cuBLAS takes one from the caching
    allocator at each handle's first product and keeps it, and the
    backward runs on autograd's own thread with a handle of its own, so
    one small product of each kind, and one small backward, come first.
    Resets the peak."""
    for dt in (torch.bfloat16, torch.float32):
        for n in (1, 8):
            w = torch.ones((64, 64), dtype=dt, device=dev,
                           requires_grad=True)
            (torch.ones((n, 64), dtype=dt, device=dev) @ w).sum().backward()
        torch.bmm(torch.ones((2, 8, 64), dtype=dt, device=dev),
                  torch.ones((2, 64, 64), dtype=dt, device=dev))
    del w
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


class AttentionHeld:
    """A stand-in for ``attention_xla.flash_attention`` (the prefill's
    entry point) that runs it and holds every call to its plain version on
    the same padded inputs: within the reference's bf16 tolerance and
    ``half_attention_error``'s limits against the float32 oracle.  Counts
    the calls by (causal, Sq, Skv)."""

    def __init__(self, torch, fa_ops, fa_ref, original, label: str):
        self.torch, self.fa_ops, self.fa_ref = torch, fa_ops, fa_ref
        self.original, self.label = original, label
        self.calls, self.err, self.worst = {}, 0.0, {}

    def __call__(self, q, k, v, *, causal, window, scale, bq, bkv):
        torch, fa_ref = self.torch, self.fa_ref
        out = self.original(q, k, v, causal=causal, window=window,
                            scale=scale, bq=bq, bkv=bkv)
        sq = q.shape[2]
        padded = self.fa_ops.pad(q, k, v, causal=causal, window=window,
                                 bq=bq, bkv=bkv)
        exp = fa_ref.attention(*padded, causal=causal, window=window,
                               scale=scale)[:, :, :sq]
        tol = ATTN_TOL["bfloat16"]
        torch.testing.assert_close(out, exp, rtol=tol, atol=tol)
        exp32 = fa_ref.attention(*(t.float() for t in padded),
                                 causal=causal, window=window,
                                 scale=scale)[:, :, :sq]
        stats = half_attention_error(out, exp32, padded[2])
        key = (causal, sq, k.shape[2])
        n = sum(self.calls.values())
        check(half_within(stats, "bfloat16"), f"{self.label} attention "
              f"call {n} {key}: outside the bf16 limits {stats}")
        self.calls[key] = self.calls.get(key, 0) + 1
        self.err = max(self.err, (out.double() - exp.double()).abs().max()
                       .item())
        for name, value in stats.items():
            self.worst[name] = max(self.worst.get(name, 0.0), value)
        return out

    def summary(self) -> str:
        shapes = ", ".join(
            f"{n} x ({'causal' if c else 'non-causal'} Sq {sq} Skv {skv})"
            for (c, sq, skv), n in self.calls.items())
        worst = ", ".join(f"{k} {v:.3e}" for k, v in self.worst.items())
        return (f"{sum(self.calls.values())} calls [{shapes}] within "
                f"{ATTN_TOL['bfloat16']} of the plain version, max_abs_err "
                f"{self.err:.3e}; bf16 limits against the f32 oracle, worst "
                f"{worst}")


def profile_classes(torch, label: str, run, wall_s: float, expect: dict,
                    ranges=()) -> tuple:
    """Run ``run`` once more under ``torch.profiler`` and print where the
    device time goes, by class: the hand-written kernels, the cuBLAS GEMMs,
    copies, the device time of each ``torch.profiler.record_function``
    range in ``ranges`` (its kernels' time, children's included; a range's
    GEMMs are not counted again among the GEMMs) and the rest; and the busy
    share of the unprofiled ``wall_s``.  ``expect`` maps a kernel name to
    its launches the trace must show.  Returns (kernels by (ms, count,
    name), total ms)."""
    from torch.profiler import ProfilerActivity, profile

    def is_gemm(name):
        name = name.lower()
        return ("gemm" in name or "nvjet" in name or "cutlass" in name
                or "xmma" in name)

    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        # the ranges' own device-side spans are no kernels
        kernels = sorted(
            ((e.self_device_time_total / 1e3, e.count, e.key)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.self_device_time_total > 0 and e.key not in ranges),
            reverse=True)
        seen = {k: sum(c for _m, c, key in kernels if k in key)
                for k in expect}
        if seen == expect:
            break
        print(f"{label} profile: the trace shows {seen}, expected {expect} "
              f"(attempt {attempt + 1} of 3)")
    check(seen == expect, f"{label} profile: {seen}, expected {expect}")
    total = sum(ms for ms, _n, _k in kernels)

    def under(event):
        """The kernels an event and its children launched."""
        yield from event.kernels
        for child in event.cpu_children:
            yield from under(child)

    parts, range_gemm = {}, 0.0
    for name in ranges:
        ms = gemm = 0.0
        for event in prof.events():
            if event.name == name:
                for kinfo in under(event):
                    ms += kinfo.duration / 1e3
                    gemm += kinfo.duration / 1e3 if is_gemm(kinfo.name) \
                        else 0.0
        parts[name] = ms
        range_gemm += gemm
    by_name = {
        "flash attention": lambda k: "flash_attention" in k,
        "attention backward": lambda k: "attention_bwd" in k,
        "linear scan": lambda k: "linear_scan" in k,
        "copies": lambda k: "copy" in k.lower(),
    }
    for cls, test in by_name.items():
        ms = sum(m for m, _n, key in kernels if test(key))
        if ms:
            parts[cls] = ms
    parts["cuBLAS GEMMs" + (" (outside the ranges)" if ranges else "")] = \
        sum(m for m, _n, key in kernels if is_gemm(key)) - range_gemm
    parts["the rest (element-wise, norms)"] = total - sum(parts.values())
    print(f"{label} profile: device kernel time {total:.3f} ms of "
          f"{wall_s * 1e3:.3f} ms wall (busy "
          f"{100 * total / (wall_s * 1e3):.1f}%); " + "; ".join(
              f"{k} {v:.3f} ms ({100 * v / max(total, 1e-9):.1f}%)"
              for k, v in parts.items()))
    for ms, cnt, key in kernels[:8]:
        print(f"{label} profile:   {ms:9.3f} ms {cnt:5d}x {key[:100]}")
    return kernels, total


def served(torch, prefill, decode, tokens, extras, n_img: int, n_dec: int,
           label: str, vocab: int):
    """Prefill ``tokens`` (with the front ends' ``extras``), then ``n_dec``
    greedy decode steps; (generated tokens, prefill wall, decode wall)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, states = prefill(tokens, **extras)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    b, s = tokens.shape
    check(tuple(logits.shape) == (b, 1, vocab)
          and bool(torch.isfinite(logits).all()),
          f"{label} prefill logits {tuple(logits.shape)} not finite")
    token = logits[:, -1].argmax(dim=-1, keepdim=True)
    out = [token]
    for t in range(n_dec):
        logits, states = decode(states, token, n_img + s + t)
        token = logits[:, -1].argmax(dim=-1, keepdim=True)
        out.append(token)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(bool(torch.isfinite(logits).all()), f"{label} decode logits not "
          f"finite")
    generated = torch.cat(out, dim=1)
    check(tuple(generated.shape) == (b, n_dec + 1)
          and bool(((generated >= 0) & (generated < vocab)).all()),
          f"{label} generated tokens {tuple(generated.shape)}")
    return generated, t1 - t0, t2 - t1


def front_ends(torch, cfg, gen, dev, batch: int, enc_len: int) -> dict:
    """The stub front ends' inputs ``cfg`` takes, float32 on the card as
    the data pipeline makes them: the encoder's frames, the patches."""
    out = {}
    if cfg.encoder_layers:
        out["frames"] = torch.randn((batch, enc_len, cfg.d_model),
                                    generator=gen, device=dev)
    if cfg.frontend == "vision":
        out["pixels"] = torch.randn((batch, cfg.vision_tokens, cfg.d_model),
                                    generator=gen, device=dev)
    return out


def teacher_forcing(torch, dev, gen, cfg, label: str, zero_counts,
                    counts) -> str:
    """The reference's serving check (tests/test_serve.py:34-62) in float32
    at FAM_TF_LAYERS layers of ``cfg``'s widths: a prefill, then
    teacher-forced decode steps, each step's logits within LM_TF_TOL of the
    full-sequence forward's.  Returns a line to print."""
    import dataclasses

    from repro_torch.models import LanguageModel
    from repro_torch.train import make_decode_step, make_prefill_step

    over = dict(n_layers=FAM_TF_LAYERS, dtype="float32")
    if cfg.encoder_layers:
        over["encoder_layers"] = FAM_TF_LAYERS
    if cfg.is_moe:
        # C = T: no token drops, as decode's C = T
        over["capacity_factor"] = cfg.n_experts / cfg.n_experts_active
    cfg32 = dataclasses.replace(cfg, **over)
    model = LanguageModel(cfg32, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    n_img = cfg.vision_tokens if cfg.frontend == "vision" else 0
    n_pre, n_tf = FAM_TF_PROMPT - n_img, FAM_TF_DECODE
    toks = torch.randint(0, cfg.vocab_size, (1, n_pre + n_tf), generator=gen,
                         device=dev)
    ext = front_ends(torch, cfg, gen, dev, 1, FAM_TF_PROMPT // 4)
    zero_counts()
    hidden = model(toks, **ext)
    full = model.logits(hidden[:, n_img + n_pre - 1:])
    del hidden
    logits, states = make_prefill_step(model, s_max=n_img + n_pre + n_tf)(
        toks[:, :n_pre], **ext)
    errs = [(logits[:, 0] - full[:, 0]).abs().max().item()]
    torch.testing.assert_close(logits[:, 0], full[:, 0], rtol=LM_TF_TOL,
                               atol=LM_TF_TOL)
    step = make_decode_step(model)
    for t in range(n_tf):
        logits, states = step(states, toks[:, n_pre + t:n_pre + t + 1],
                              n_img + n_pre + t)
        torch.testing.assert_close(logits[:, 0], full[:, t + 1],
                                   rtol=LM_TF_TOL, atol=LM_TF_TOL)
        errs.append((logits[:, 0] - full[:, t + 1]).abs().max().item())
    got = {k: v for k, v in counts().items() if v}
    check(set(got) <= {"flash_attention"}, f"{label} float32 check "
          f"launched {got}")
    del model, full, logits, states, step, toks, ext
    return (f"{label} teacher forcing, float32, {FAM_TF_LAYERS} layers"
            f"{' (encoder too)' if cfg.encoder_layers else ''}: prefill "
            f"{n_img + n_pre} positions, then {n_tf} decode steps against "
            f"the full-sequence forward: max_abs_err "
            f"{max(errs):.3e} (<= {LM_TF_TOL}); launches {got}")


# the LM phase: RecurrentGemma-9B at its published widths and depth
# (src/repro/configs/recurrentgemma_9b.py), bf16, random weights from SEED;
# B prompts of S tokens (S past the 2048 window), then greedy decode steps
LM_ARCH = "recurrentgemma_9b"
LM_PARAMS = 9_395_666_944
LM_BATCH, LM_PROMPT, LM_DECODE = 2, 4096, 32
# kernel calls per prefill: one flash_attention per local_attn block, one
# linear_scan per rglru block (12 x (rglru, rglru, local_attn) + 2 rglru)
LM_KERNELS = {"flash_attention": ("bf16_wgmma", 12),
              "linear_scan": ("tma", 26)}
# teacher forcing in float32 at one pattern period (3 layers: rglru,
# rglru, local_attn): prefill past the window (a prompt of whole 1024-key
# chunks, as the chunked path requires), then decode steps against the
# full-sequence forward, the reference's own serving check
# (tests/test_serve.py:34-62) at its tolerance
LM_TF_LAYERS, LM_TF_PROMPT, LM_TF_DECODE = 3, 3072, 4
LM_TF_TOL = 2e-3


def lm_phase(torch, dev, gen, card: str, zero_counts, counts) -> dict:
    """``[lm]``: serve RecurrentGemma-9B on the card through the port's
    entry points (``LanguageModel``, ``make_prefill_step``,
    ``make_decode_step``), check the kernels its prefill launches, hold
    each of them against its plain version, check decode against the
    full sequence in float32, and print the walls, rates, bounds, busy
    shares and where the device time goes.  Returns, per kernel entry
    point, its launches per prefill and its mean device time there."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.linear_scan import kernel as ls_kernel
    from repro_torch.kernels.linear_scan import ops as ls_ops
    from repro_torch.kernels.linear_scan import ref as ls_ref
    from repro_torch.models import LanguageModel, attention_xla, recurrent
    from repro_torch.models.blocks import count_params
    from repro_torch.train import make_decode_step, make_prefill_step

    def sync():
        torch.cuda.synchronize()

    base = memory_base(torch, dev)

    # -- build the model at full width and depth ---------------------------
    cfg = configs.get(LM_ARCH)
    t0 = time.perf_counter()
    model = LanguageModel(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    sync()
    t_init = time.perf_counter() - t0
    n_matrix = model.param_count()
    check(n_matrix == count_params(cfg) == LM_PARAMS,
          f"[lm] {n_matrix} parameters in weight matrices, count_params "
          f"{count_params(cfg)}, expected {LM_PARAMS}")
    n_all = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    kinds = [kind for _, kind in model.layers()]
    check(len(kinds) == cfg.n_layers == 38, f"[lm] {len(kinds)} layers")
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers ({kinds.count('rglru')} "
          f"rglru, {kinds.count('local_attn')} local_attn), d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, "
          f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, lru_width "
          f"{cfg.lru_width}, window {cfg.window}, vocab {cfg.vocab_size}, "
          f"{model.dtype}; {n_matrix:,} parameters in weight matrices "
          f"(= count_params), {n_all:,} with norms, lam and conv_b; "
          f"{w_bytes:,} bytes; drawn on the card from seed {SEED} in "
          f"{t_init:.3f} s ({card})")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
          "[lm] non-finite initial parameters")
    after_model = torch.cuda.memory_allocated(dev)

    # -- serve through the port's entry points ---------------------------
    b, s, n_dec = LM_BATCH, LM_PROMPT, LM_DECODE
    prefill = make_prefill_step(model, s_max=s + n_dec)
    decode = make_decode_step(model)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)

    def serve():
        """Prefill, then n_dec greedy decode steps; (tokens, walls)."""
        return served(torch, prefill, decode, tokens, {}, 0, n_dec, "[lm]",
                      cfg.vocab_size)

    # the plain versions, counted by wrappers installed here: a served run
    # must call neither; the operands the entry points are handed, and
    # how many of them a row-major copy takes
    plain = {"flash_attention": 0, "linear_scan": 0}
    handed = {"operands": 0, "strided": 0, "strided_bytes": 0}
    originals = {"fa_ref": fa_ref.attention, "ls_ref": ls_ref.linear_scan,
                 "fa": attention_xla.flash_attention,
                 "ls": recurrent.linear_scan}

    def counting_plain(name, fn):
        def wrapper(*args, **kwargs):
            plain[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    def watching(fn):
        def wrapper(*tensors, **kwargs):
            for t in tensors:
                handed["operands"] += 1
                if not t.is_contiguous():
                    handed["strided"] += 1
                    handed["strided_bytes"] += t.numel() * t.element_size()
            return fn(*tensors, **kwargs)
        return wrapper

    # a prefill records no gradient, so no launch writes a log-sum-exp
    lse_writes = [0]
    originals["fa_launch"] = fa_kernel.launch

    def launch_watched(*args, lse=None, **kwargs):
        lse_writes[0] += lse is not None
        return originals["fa_launch"](*args, lse=lse, **kwargs)

    fa_ref.attention = counting_plain("flash_attention", fa_ref.attention)
    ls_ref.linear_scan = counting_plain("linear_scan", ls_ref.linear_scan)
    attention_xla.flash_attention = watching(originals["fa"])
    recurrent.linear_scan = watching(originals["ls"])
    fa_kernel.launch = launch_watched
    try:
        cold = serve()
        zero_counts()
        for key in plain:
            plain[key] = 0
        for key in handed:
            handed[key] = 0
        generated, t_prefill, t_decode = serve()
        got = counts()
    finally:
        fa_ref.attention = originals["fa_ref"]
        ls_ref.linear_scan = originals["ls_ref"]
        attention_xla.flash_attention = originals["fa"]
        recurrent.linear_scan = originals["ls"]
        fa_kernel.launch = originals["fa_launch"]
    check(torch.equal(generated, cold[0]), "[lm] two served runs of the "
          "same prompt generated different tokens")
    for name, (route, want) in LM_KERNELS.items():
        wrapper = {"flash_attention": fa_ops.flash_attention,
                   "linear_scan": ls_ops.linear_scan}[name]
        check(got[name] == want and wrapper.routes == {route: want},
              f"[lm] {name}: {got[name]} launches by route "
              f"{wrapper.routes}, expected {want} on {route} a prefill")
    others = {k: v for k, v in got.items() if v and k not in LM_KERNELS}
    check(not others, f"[lm] unexpected launches {others}")
    check(plain == {"flash_attention": 0, "linear_scan": 0},
          f"[lm] the served run called plain versions: {plain}")
    check(lse_writes[0] == 0, f"[lm] {lse_writes[0]} attention launches of "
          f"the served runs wrote a log-sum-exp")
    print(f"[lm] served run: {got['flash_attention']} flash_attention "
          f"launches on {fa_ops.flash_attention.routes}, "
          f"{got['linear_scan']} linear_scan on "
          f"{ls_ops.linear_scan.routes}, no other kernel wrapper; plain "
          f"versions called {plain}; no log-sum-exp written; "
          f"{handed['operands']} operands handed "
          f"to the entry points, {handed['strided']} strided "
          f"({handed['strided_bytes']} bytes copied to row-major)")

    pre_flops = 2 * (n_matrix - cfg.vocab_size * cfg.d_model) * b * s
    w = min(cfg.window, s)
    visible = b * (w * (w + 1) // 2 + (s - w) * w)
    attn_flops = 4 * cfg.n_heads * cfg.head_dim * visible * kinds.count(
        "local_attn")
    head_flops = 2 * b * cfg.d_model * cfg.vocab_size
    pre_bound = (pre_flops + attn_flops + head_flops) / PEAK_FLOPS[
        "bfloat16"] * 1e3
    dec_bound = w_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[lm] prefill {b} x {s} tokens: cold {cold[1]:.4f} s, warm "
          f"{t_prefill:.4f} s, {b * s / t_prefill:.1f} tokens/s; bound "
          f"{pre_bound:.3f} ms (({pre_flops:.4e} weight + {attn_flops:.4e} "
          f"attention + {head_flops:.4e} head) FLOP at 989 TFLOP/s bf16), "
          f"{pre_bound / 1e3 / t_prefill * 100:.1f}% of it ({card})")
    print(f"[lm] decode {n_dec} steps x {b}: cold {cold[2]:.4f} s, warm "
          f"{t_decode:.4f} s, {t_decode / n_dec * 1e3:.3f} ms a step, "
          f"{b * n_dec / t_decode:.1f} tokens/s; bound {dec_bound:.3f} ms a "
          f"step ({w_bytes:,} weight bytes at 3.35 TB/s), "
          f"{dec_bound / (t_decode / n_dec * 1e3) * 100:.1f}% of it ({card})")

    # -- where the device time goes --------------------------------------
    pre_kernels, _ = profile_classes(
        torch, "[lm] prefill", lambda: prefill(tokens), t_prefill,
        {"flash_attention_wgmma_kernel": 12, "linear_scan_kernel": 26})
    _, states = prefill(tokens)
    token = generated[:, :1]

    def decode_run():
        st = states
        for t in range(n_dec):
            _, st = decode(st, token, s + t)

    profile_classes(torch, "[lm] decode", decode_run, t_decode,
                    {"flash_attention": 0, "linear_scan": 0})
    del states
    kernel_ms = {}
    for name, key in (("flash_attention", "flash_attention_wgmma_kernel"),
                      ("linear_scan", "linear_scan_kernel")):
        ms = sum(m for m, _n, k in pre_kernels if key in k)
        kernel_ms[name] = ms / LM_KERNELS[name][1]
        print(f"[lm] {key} inside the served prefill: {ms:.3f} ms for "
              f"{LM_KERNELS[name][1]} launches, {kernel_ms[name]:.4f} ms "
              f"each ({card})")
    print(f"[lm] peak device memory {torch.cuda.max_memory_allocated(dev):,}"
          f" bytes with {after_model - base:,} of weights ({card})")

    # -- every kernel call of one prefill against its plain version -------
    held = AttentionHeld(torch, fa_ops, fa_ref, originals["fa"], "[lm]")
    scans = {"calls": 0, "oracle": 0.0}

    def scan_held(a, x):
        out = originals["ls"](a, x)
        exp = ls_ref.linear_scan_chunked(a, x, chunk=ls_kernel.CHUNK)
        check(torch.equal(bits(torch, out), bits(torch, exp)),
              f"[lm] scan call {scans['calls']}: not bit for bit "
              f"ref.linear_scan_chunked")
        oracle = ls_ref.linear_scan(a, x)
        tol = SCAN_TOL["float32"]
        torch.testing.assert_close(out, oracle, rtol=tol, atol=tol)
        scans["oracle"] = max(scans["oracle"], (
            out.double() - oracle.double()).abs().max().item())
        scans["calls"] += 1
        return out

    attention_xla.flash_attention = held
    recurrent.linear_scan = scan_held
    try:
        t0 = time.perf_counter()
        prefill(tokens)
        sync()
    finally:
        attention_xla.flash_attention = originals["fa"]
        recurrent.linear_scan = originals["ls"]
    check(sum(held.calls.values()) == 12 and scans["calls"] == 26,
          f"[lm] held {held.calls} attention and {scans['calls']} scan "
          f"calls, expected 12 and 26")
    print(f"[lm] every kernel call of one prefill against its plain "
          f"version ({time.perf_counter() - t0:.3f} s): flash_attention "
          f"(bf16, {tuple(tokens.shape)} prompts) {held.summary()}; 26 "
          f"linear_scan (f32 ({b}, {s}, {cfg.lru_width})) bit for bit "
          f"ref.linear_scan_chunked, max_abs_err {scans['oracle']:.3e} "
          f"against the sequential oracle (<= {SCAN_TOL['float32']})")
    del model, prefill, decode, tokens, generated, cold, held
    memory_back(torch, dev, base, "[lm] the bf16 model")

    # -- decode against the full sequence, float32 ----------------------------
    cfg32 = dataclasses.replace(cfg, n_layers=LM_TF_LAYERS, dtype="float32")
    model = LanguageModel(cfg32, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    n32 = model.param_count()
    n_pre, n_tf = LM_TF_PROMPT, LM_TF_DECODE
    # the draw of the phase's 8 decode steps, whatever n_tf: the phases
    # after it draw from the same generator
    toks = torch.randint(0, cfg.vocab_size, (1, n_pre + 8), generator=gen,
                         device=dev)[:, :n_pre + n_tf]
    zero_counts()
    hidden = model(toks)
    full = model.logits(hidden[:, n_pre - 1:])          # (1, n_tf + 1, V)
    del hidden
    logits, states = make_prefill_step(model, s_max=n_pre + n_tf)(
        toks[:, :n_pre])
    tf_err = [(logits[:, 0] - full[:, 0]).abs().max().item()]
    torch.testing.assert_close(logits[:, 0], full[:, 0], rtol=LM_TF_TOL,
                               atol=LM_TF_TOL)
    step = make_decode_step(model)
    for t in range(n_tf):
        logits, states = step(states, toks[:, n_pre + t:n_pre + t + 1],
                              n_pre + t)
        torch.testing.assert_close(logits[:, 0], full[:, t + 1],
                                   rtol=LM_TF_TOL, atol=LM_TF_TOL)
        tf_err.append((logits[:, 0] - full[:, t + 1]).abs().max().item())
    got = counts()
    # the forward and the prefill: one call a layer of each kernel's kind
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)]
             for i in range(LM_TF_LAYERS)]
    want32 = {"flash_attention": 2 * kinds.count("local_attn"),
              "linear_scan": 2 * kinds.count("rglru")}
    check({k: got[k] for k in want32} == want32
          and fa_ops.flash_attention.routes == {
              "f32_3xtf32": want32["flash_attention"]}
          and ls_ops.linear_scan.routes == {"tma": want32["linear_scan"]},
          f"[lm] float32 forward and prefill launched {got}, routes "
          f"{fa_ops.flash_attention.routes} / {ls_ops.linear_scan.routes}")
    print(f"[lm] teacher forcing, float32, {LM_TF_LAYERS} layers ({n32:,} "
          f"parameters in weight matrices): prefill {n_pre} tokens "
          f"(window {cfg.window}), then {n_tf} decode steps against the "
          f"full-sequence forward: max_abs_err "
          f"{', '.join(f'{e:.3e}' for e in tf_err)} (<= {LM_TF_TOL}); "
          f"kernels {want32} on f32_3xtf32 / tma")
    del model, full, logits, states, step, toks
    memory_back(torch, dev, base, "[lm] the phase")
    return {name: {"lm_launches": want, "lm_route": route,
                   "lm_ms": kernel_ms[name]}
            for name, (route, want) in LM_KERNELS.items()}


# the training phase: RecurrentGemma-9B at its published widths, depth cut
# to one pattern period (rglru, rglru, local_attn) so that both kernels and
# both backwards run; bf16, random weights from SEED, B 1 x S 4096 (past the
# 2048 window, which then binds in both directions), remat on, 10 steps of
# the reference's AdamW under warmup_cosine
TRAIN_LAYERS = 3
TRAIN_PARAMS = 1_705_017_344           # count_params of the 3-layer model
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 1, 4096, 10
TRAIN_LR = (1e-3, 2, TRAIN_STEPS)      # warmup_cosine(peak, warmup, total)
# kernel launches a step, and the route of each: with remat each group's
# forward runs twice, so 2 flash_attention forwards and 4 linear_scan
# forwards, then one attention backward and 2 scans over the reversed
# sequence (the scan's backward)
TRAIN_KERNELS = {"flash_attention": ("bf16_wgmma", 2),
                 "flash_attention_bwd": ("bf16_wgmma", 1),
                 "linear_scan": ("tma", 6)}
# the float32 step through the kernels against the same step with the plain
# versions on the card: per tensor, the largest difference over the largest
# |plain value| (f32 sums in other orders through three layers, the loss and
# its gradient: ~1e-5 expected)
TRAIN_F32_TOL = 1e-3
# the attention backward against its plain version in f32: rms error per
# (batch, head) slice over the plain version's rms (the forward's f32
# tolerance, 2e-5); bf16 takes BF16_SLICE_NRMS (2^-7)
BWD_F32_NRMS = 2e-5
# the optimizer's bytes a parameter: the bf16 gradient read twice (the norm,
# the update), m, v and the float32 master each read and written, the bf16
# parameter written
OPT_BYTES_PER_PARAM = 2 * 2 + 3 * 2 * 4 + 2
# the attention backward timed at RecurrentGemma-9B's training shape and at
# Qwen3-14B's width (40 query heads over 8, causal): (B, Hq, Hkv, S, D,
# window, dtypes); bf16 on both its routes
# the kernels of one bf16_wgmma backward (the head groups' sum only where
# the dk/dv kernel splits a kv head's query heads, ops.launch_bwd)
BWD_WGMMA_KERNELS = ("attention_bwd_delta_kernel",
                     "attention_bwd_dq_wgmma_kernel",
                     "attention_bwd_dkv_wgmma_kernel",
                     "attention_bwd_dkv_sum_kernel")
# (and in float32, where the f32_3xtf32 route takes it: Qwen3-14B's width
# and h2o-danube-1.8b's FSDP step shape, [lm_mesh]'s (d) / (e))
# (and in float16, on f16_wgmma and f16_simt, at RG-9B's and Qwen3-14B's)
BWD_SHAPES = {"RecurrentGemma-9B": (1, 16, 1, 4096, 256, 2048,
                                    ("bfloat16", "float32", "float16")),
              "Qwen3-14B": (1, 40, 8, 4096, 128, None,
                            ("bfloat16", "float32", "float16")),
              "h2o-danube-1.8b": (8, 32, 8, 1024, 80, 4096, ("float32",)),
              # Gemma-7B's training shape, on d 256's 3xTF32 blocks
              "Gemma-7B": (1, 16, 16, 4096, 256, None, ("float32",))}


def odd_offset(t):
    """A copy of ``t`` one element into its storage: the same values, an
    address no 16-byte-aligned route can read."""
    view = t.new_empty(t.numel() + 1)[1:].view(t.shape)
    view.copy_(t)
    return view


def slice_nrms(got, exp) -> float:
    """The largest rms error of a (batch, head) slice of ``got`` (B, H, S,
    D) over ``exp``'s rms there."""
    err = (got.double() - exp.double()).square().sum((2, 3))
    ref = exp.double().square().sum((2, 3)).clamp_min(1e-300)
    return (err / ref).sqrt().max().item()


def train_phase(torch, dev, card: str, zero_counts, counts) -> dict:
    """``[train]``: train RecurrentGemma-9B at its published widths (3
    layers) on the card through the port's entry points
    (``LanguageModel.loss``, ``AdamW``, ``warmup_cosine``,
    ``SyntheticLMDataset``, ``make_train_step``); check the losses, the
    first step's gradients, the kernels every step launches and each
    backward launch of step 1 against its plain version, a float32 step
    against the same step on the plain versions, and the memory; print the
    step wall, rates, bound, busy share, device time by class and peak
    memory; time the attention backward at two widths beside its bound,
    its plain version and SDPA's backward.  Returns the ``kernels`` line's
    additions: ``train_launches`` for the two kernels and the attention
    backward's row."""
    import dataclasses
    import statistics

    from repro_torch import configs
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.linear_scan import kernel as ls_kernel
    from repro_torch.kernels.linear_scan import ops as ls_ops
    from repro_torch.kernels.linear_scan import ref as ls_ref
    from repro_torch.models import LanguageModel
    from repro_torch.models.blocks import count_params
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train import make_train_step
    from torch.profiler import ProfilerActivity, profile

    def sync():
        torch.cuda.synchronize()

    base = memory_base(torch, dev)

    # -- the model, at full width and one pattern period deep ---------------
    cfg = dataclasses.replace(configs.get(LM_ARCH), n_layers=TRAIN_LAYERS)
    n_params = count_params(cfg)
    check(n_params == TRAIN_PARAMS, f"[train] count_params {n_params}, "
          f"expected {TRAIN_PARAMS}")
    t0 = time.perf_counter()
    model = LanguageModel(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    sync()
    t_init = time.perf_counter() - t0
    kinds = [kind for _, kind in model.layers()]
    check(kinds == ["rglru", "rglru", "local_attn"], f"[train] {kinds}")
    check(model.param_count() == n_params, "[train] param_count")
    n_all = sum(p.numel() for p in model.parameters())
    print(f"[train] {cfg.name} at its published widths (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, "
          f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, lru_width "
          f"{cfg.lru_width}, window {cfg.window}, vocab {cfg.vocab_size}, "
          f"tied embeddings), depth cut from 38 to {TRAIN_LAYERS} layers "
          f"({', '.join(kinds)}), {model.dtype}: {n_params:,} parameters "
          f"in weight matrices, {n_all:,} in all; drawn on the card from "
          f"seed {SEED} in {t_init:.3f} s; B {TRAIN_BATCH} x S {TRAIN_SEQ}, "
          f"remat on, AdamW with warmup_cosine{TRAIN_LR} ({card})")

    # -- plain versions counted; step 1's backward launches held ----------
    plain_names = (("attention", fa_ref), ("attention_grad", fa_ref),
                   ("linear_scan", ls_ref))
    originals = {name: getattr(mod, name) for name, mod in plain_names}
    # the attention Function's backward (a staticmethod), held in step 1;
    # the entry point it calls keeps its name, so it counts its launches
    originals.update(backward=fa_ops._Attention.__dict__["backward"],
                     kernel_scan=ls_ops._kernel_scan,
                     scan_bwd=ls_ops.linear_scan_bwd)
    plain = {name: 0 for name, _ in plain_names}
    holding = [False]
    held = {"attention_bwd": 0, "nrms": 0.0, "err": 0.0, "scan": 0,
            "scan_bwd": 0, "lse": False}

    def counting(name):
        fn = originals[name]

        def wrapper(*args, **kwargs):
            plain[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    def bwd_held(ctx, dout):
        # what _Attention.backward does (its saved tensors can be unpacked
        # once under remat), with step 1's result held
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        held["lse"] = lse is not None
        got = fa_ops.flash_attention_bwd(q, k, v, out, dout, lse=lse,
                                         causal=causal, window=window,
                                         scale=scale)
        if holding[0]:
            exp = originals["attention_grad"](
                q.float(), k.float(), v.float(), dout.float(), causal=causal,
                window=window, scale=scale)
            for name, g, e in zip(("dq", "dk", "dv"), got, exp):
                check(g.dtype == q.dtype and bool(torch.isfinite(g).all()),
                      f"[train] attention backward {name}: {g.dtype}, "
                      f"finite {bool(torch.isfinite(g).all())}")
                nrms = slice_nrms(g, e)
                check(nrms <= BF16_SLICE_NRMS, f"[train] attention backward "
                      f"{name}: rms error per head slice {nrms:.3e} of the "
                      f"plain version's (> {BF16_SLICE_NRMS:.3e})")
                held["nrms"] = max(held["nrms"], nrms)
                held["err"] = max(held["err"], (g.double() - e.double())
                                  .abs().max().item())
            held["attention_bwd"] += 1
        return (*got, None, None, None, None)

    def scan_held(a, x):
        out = originals["kernel_scan"](a, x)
        if holding[0]:
            exp = ls_ref.linear_scan_chunked(a, x, chunk=ls_kernel.CHUNK)
            check(torch.equal(bits(torch, out), bits(torch, exp)),
                  f"[train] scan launch {held['scan']}: not bit for bit "
                  f"ref.linear_scan_chunked")
            held["scan"] += 1
        return out

    def scan_bwd_counted(a, y, g):
        if holding[0]:
            held["scan_bwd"] += 1
        return originals["scan_bwd"](a, y, g)

    def install():
        for name, mod in plain_names:
            setattr(mod, name, counting(name))
        fa_ops._Attention.backward = staticmethod(bwd_held)
        ls_ops._kernel_scan = scan_held
        ls_ops.linear_scan_bwd = scan_bwd_counted

    def restore():
        for name, mod in plain_names:
            setattr(mod, name, originals[name])
        fa_ops._Attention.backward = originals["backward"]
        ls_ops._kernel_scan = originals["kernel_scan"]
        ls_ops.linear_scan_bwd = originals["scan_bwd"]

    first_grads = {}
    opt_ms = []

    class Watching(AdamW):
        """AdamW that reads the first step's gradients and times each
        update with CUDA events."""

        def update(self, grads, state, params):
            if state.count == 0:
                for name, g in grads.items():
                    first_grads[name] = (bool(torch.isfinite(g).all()),
                                         g.float().abs().max().item())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = super().update(grads, state, params)
            end.record()
            opt_ms.append((start, end))
            return out

    # -- 10 steps --------------------------------------------------------------
    opt = Watching(learning_rate=warmup_cosine(*TRAIN_LR))
    state = opt.init(model)
    step = make_train_step(model, opt)
    data = SyntheticLMDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                              seed=SEED, device=dev)
    batches = [data.batch_at(i) for i in range(TRAIN_STEPS + 1)]
    losses, norms, walls = [], [], []
    install()
    try:
        zero_counts()
        for i in range(TRAIN_STEPS):
            holding[0] = i == 0
            sync()
            t0 = time.perf_counter()
            state, metrics = step(state, batches[i])
            sync()
            walls.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        holding[0] = False
        got = counts()
        routes = {"flash_attention": dict(fa_ops.flash_attention.routes),
                  "flash_attention_bwd":
                      dict(fa_ops.flash_attention_bwd.routes),
                  "linear_scan": dict(ls_ops.linear_scan.routes)}
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(x) for x in losses + norms),
          f"[train] losses {losses}, grad norms {norms}")
    check(statistics.mean(losses[-3:]) < losses[0],
          f"[train] the loss did not fall: {losses}")
    names = [n for n, _ in model.named_parameters()]
    check(sorted(first_grads) == sorted(names),
          "[train] step 1 did not see every parameter's gradient")
    bad = [n for n, (finite, top) in first_grads.items()
           if not finite or top == 0.0]
    check(not bad, f"[train] step 1: zero or non-finite gradients {bad}")
    for name, (route, per_step) in TRAIN_KERNELS.items():
        want = per_step * TRAIN_STEPS
        check(got[name] == want and routes[name] == {route: want},
              f"[train] {name}: {got[name]} launches by route "
              f"{routes[name]}, expected {want} on {route} "
              f"({per_step} a step)")
    others = {k: v for k, v in got.items() if v and k not in TRAIN_KERNELS}
    check(not others, f"[train] unexpected launches {others}")
    check(not any(plain.values()), f"[train] plain versions called {plain}")
    check(held["attention_bwd"] == 1 and held["scan"] == 6
          and held["scan_bwd"] == 2 and held["lse"],
          f"[train] step 1 held {held}, expected 1 attention backward (with "
          f"the forward's log-sum-exp saved), 6 scan launches of which 2 "
          f"backward")
    print(f"[train] losses {', '.join(f'{x:.4f}' for x in losses)}; grad "
          f"norms {', '.join(f'{x:.4f}' for x in norms)}: finite, the last "
          f"three's mean {statistics.mean(losses[-3:]):.4f} below the first")
    print(f"[train] step 1: all {len(first_grads)} parameters got a finite, "
          f"non-zero gradient (smallest max |g| "
          f"{min(top for _, top in first_grads.values()):.3e}); its "
          f"attention backward held to its plain version (float32 on the "
          f"same bf16 inputs): rms error per head slice at most "
          f"{held['nrms']:.3e} of the plain version's (<= "
          f"{BF16_SLICE_NRMS:.3e}), max_abs_err {held['err']:.3e}; its 6 "
          f"linear_scan launches (4 forward, 2 backward over the reversed "
          f"sequence) bit for bit ref.linear_scan_chunked")
    print(f"[train] launches over {TRAIN_STEPS} steps: "
          + ", ".join(f"{k} {got[k]} on {routes[k]}" for k in TRAIN_KERNELS)
          + f"; no other kernel wrapper; plain versions called {plain}")

    warm = statistics.median(walls[2:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    model_flops = 6 * n_params * tokens
    t_ops = model_flops / PEAK_FLOPS["bfloat16"] * 1e3
    opt_bytes = n_all * OPT_BYTES_PER_PARAM
    t_opt = opt_bytes / HBM_BYTES_PER_S * 1e3
    bound = t_ops + t_opt
    sync()
    opt_times = [a.elapsed_time(b) for a, b in opt_ms]
    print(f"[train] step walls {', '.join(f'{w:.4f}' for w in walls)} s; "
          f"warm (median of steps 3-{TRAIN_STEPS}) {warm:.4f} s, "
          f"{tokens / warm:.1f} tokens/s; model FLOP/s "
          f"{model_flops / warm / 1e12:.2f} TFLOP/s (6 N T = "
          f"{model_flops:.4e}), {100 * model_flops / warm / PEAK_FLOPS['bfloat16']:.1f}% "
          f"of the bf16 dense peak; bound {bound:.3f} ms ({t_ops:.3f} ms of "
          f"6 N T at 989 TFLOP/s + {t_opt:.3f} ms of the optimizer's "
          f"{opt_bytes:.4e} bytes at 3.35 TB/s), "
          f"{100 * bound / (warm * 1e3):.1f}% of it; the optimizer "
          f"{statistics.median(opt_times[2:]):.3f} ms a step (CUDA events); "
          f"peak device memory {peak:,} bytes ({card})")

    # -- where a step's device time goes -------------------------------------
    # the kernels a step launches, by name: the forward twice, the
    # backward's bf16_wgmma kernels once (the CUDA-core ones never), the
    # scan six times
    groups = fa_kernel.dkv_groups(
        cfg.n_heads, cfg.n_kv_heads, TRAIN_BATCH, TRAIN_SEQ,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    profiled = {"flash_attention_wgmma_kernel": 2,
                **{name: int(groups > 1 or "sum" not in name)
                   for name in BWD_WGMMA_KERNELS},
                "attention_bwd_dq_kernel": 0, "attention_bwd_dkv_kernel": 0,
                "linear_scan_kernel": 6}
    for attempt in range(3):
        del opt_ms[:]
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, metrics = step(state, batches[TRAIN_STEPS])
            sync()
        kernels = sorted(
            ((e.self_device_time_total / 1e3, e.count, e.key)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.self_device_time_total > 0), reverse=True)
        seen = {k: sum(c for _m, c, key in kernels if k in key)
                for k in profiled}
        if seen == profiled:
            break
        print(f"[train] profile: the trace shows {seen} (attempt "
              f"{attempt + 1} of 3)")
    check(seen == profiled, f"[train] profile of a step: {seen}, expected "
          f"{profiled}")
    total = sum(ms for ms, _n, _k in kernels)

    def share(test):
        return sum(ms for ms, _n, key in kernels if test(key.lower()))

    opt_dev = opt_ms[-1][0].elapsed_time(opt_ms[-1][1])
    parts = {
        "cuBLAS GEMMs": share(lambda k: ("gemm" in k or "nvjet" in k
                                         or "cutlass" in k or "xmma" in k)),
        "attention forward": share(lambda k: "flash_attention" in k),
        "attention backward": share(lambda k: "attention_bwd" in k),
        "scan": share(lambda k: "linear_scan" in k),
        "copies": share(lambda k: "copy" in k),
    }
    parts["optimizer (events)"] = opt_dev
    parts["element-wise and the rest"] = total - sum(parts.values())
    print(f"[train] profile of one more step: device kernel time "
          f"{total:.3f} ms of the warm {warm * 1e3:.3f} ms wall (busy "
          f"{100 * total / (warm * 1e3):.1f}%); " + "; ".join(
              f"{k} {v:.3f} ms ({100 * v / max(total, 1e-9):.1f}%)"
              for k, v in parts.items()) + f" ({card})")
    for ms, cnt, key in kernels[:10]:
        print(f"[train] profile:   {ms:9.3f} ms {cnt:5d}x {key[:100]}")
    del model, state, step, opt, batches, metrics, prof, kernels, opt_ms
    first_grads.clear()
    gc.collect()
    sync()
    left = torch.cuda.memory_allocated(dev) - base
    check(left < 4 << 20, f"[train] {left} bytes still allocated after the "
          f"bf16 model was dropped (largest blocks {held_blocks(torch)})")
    print(f"[train] device memory held after the bf16 run: {left} bytes")

    # -- one float32 step: through the kernels, then on the plain versions ---
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = LanguageModel(cfg32, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    model.requires_grad_(True)
    batch = data.batch_at(0)

    def loss_and_grads():
        loss, _ = model.loss(batch)
        loss.backward()
        grads = {}
        for name, p in model.named_parameters():
            grads[name], p.grad = p.grad, None
        return loss.detach(), grads

    zero_counts()
    loss_k, grads_k = loss_and_grads()
    sync()
    got = counts()
    # the routes the rule gives RecurrentGemma-9B's d 256 in float32: the
    # tensor cores in 3xTF32 both ways (the forward saves its log-sum-exp
    # for the backward)
    fwd32 = fa_ops.route(torch.float32, cfg.head_dim)
    bwd32 = fa_ops.bwd_route(torch.float32, cfg.head_dim)
    check((fwd32, bwd32) == ("f32_3xtf32", "f32_3xtf32"), f"[train] float32 "
          f"routes {fwd32} / {bwd32} at d {cfg.head_dim}")
    want32 = {"flash_attention": {fwd32: 2},
              "flash_attention_bwd": {bwd32: 1},
              "linear_scan": {"tma": 6}}
    routes = {"flash_attention": fa_ops.flash_attention.routes,
              "flash_attention_bwd": fa_ops.flash_attention_bwd.routes,
              "linear_scan": ls_ops.linear_scan.routes}
    check(routes == want32 and not {k: v for k, v in got.items()
                                    if v and k not in want32},
          f"[train] float32 step launched {got}, routes {routes}")
    # the step again through the kernels, timed
    sync()
    t0 = time.perf_counter()
    loss_and_grads()
    sync()
    t_kernels = time.perf_counter() - t0

    def attend_plain(q, k, v, *, causal, window, scale, lse):
        return originals["attention"](q, k, v, causal=causal, window=window,
                                      scale=scale), None

    def bwd_plain(q, k, v, out, dout, lse=None, **kw):
        return originals["attention_grad"](q, k, v, dout, **kw)

    kernels_fns = (fa_ops._attend, fa_ops.flash_attention_bwd,
                   ls_ops._kernel_scan)
    fa_ops._attend, fa_ops.flash_attention_bwd = attend_plain, bwd_plain
    ls_ops._kernel_scan = originals["linear_scan"]
    try:
        zero_counts()
        t0 = time.perf_counter()
        loss_p, grads_p = loss_and_grads()
        sync()
        t_plain = time.perf_counter() - t0
        got = counts()
    finally:
        (fa_ops._attend, fa_ops.flash_attention_bwd,
         ls_ops._kernel_scan) = kernels_fns
    check(not any(got.values()), f"[train] the plain float32 step launched "
          f"{got}")
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    check(loss_err <= TRAIN_F32_TOL, f"[train] float32 loss "
          f"{loss_k.item()} through the kernels, {loss_p.item()} plain")
    worst, worst_name = 0.0, None
    for name, gp in grads_p.items():
        rel = ((grads_k[name] - gp).abs().max()
               / gp.abs().max().clamp_min(1e-30)).item()
        check(math.isfinite(rel) and rel <= TRAIN_F32_TOL,
              f"[train] float32 gradient {name}: largest difference "
              f"{rel:.3e} of its largest |value| (> {TRAIN_F32_TOL})")
        if rel >= worst:
            worst, worst_name = rel, name
    print(f"[train] float32 step ({TRAIN_LAYERS} layers, B {TRAIN_BATCH} x "
          f"S {TRAIN_SEQ}): loss {loss_k.item():.6f} through the kernels "
          f"(flash_attention {fwd32} x 2, its backward {bwd32} x 1, "
          f"linear_scan tma x 6; the loss and its gradient again "
          f"{t_kernels:.3f} s), {loss_p.item():.6f} on the plain versions "
          f"on the card ({t_plain:.3f} s; relative difference "
          f"{loss_err:.3e}); all {len(grads_p)} gradients within "
          f"{TRAIN_F32_TOL} of their largest |value| (worst {worst:.3e}, "
          f"{worst_name})")
    del model, batch, grads_k, grads_p, gp, loss_k, loss_p, data
    gc.collect()
    sync()
    left = torch.cuda.memory_allocated(dev) - base
    check(left < 4 << 20, f"[train] {left} bytes still allocated after the "
          f"float32 step (largest blocks {held_blocks(torch)})")

    # -- the attention backward at two widths --------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bwd_times = {(name, dname): attention_bwd_timed(
        torch, dev, gen, card, name, dname, *shape[:-1])
        for name, shape in BWD_SHAPES.items() for dname in shape[-1]}
    overflow = f16_overflow_case(torch, dev, gen, card)
    gc.collect()
    sync()
    left = torch.cuda.memory_allocated(dev) - base
    check(left < 4 << 20, f"[train] {left} bytes still allocated after the "
          f"phase (largest blocks {held_blocks(torch)})")
    print(f"[train] device memory held after the phase: {left} bytes")
    per_step = {k: v for k, (_r, v) in TRAIN_KERNELS.items()}
    return {
        "flash_attention": {"train_launches": per_step["flash_attention"]},
        "linear_scan": {"train_launches": per_step["linear_scan"]},
        "flash_attention_bwd": dict(
            launches=per_step["flash_attention_bwd"] * TRAIN_STEPS,
            train_launches=per_step["flash_attention_bwd"],
            train_route=TRAIN_KERNELS["flash_attention_bwd"][0],
            **{k: v for k, v in bwd_times[("RecurrentGemma-9B",
                                           "bfloat16")].items()
               if k not in ("route_ms", "checked_launches")},
            # each route's time at both widths
            route_ms={f"{name} {dname}": times["route_ms"]
                      for (name, dname), times in bwd_times.items()}),
        # the float32 route on the tensor cores at h2o-danube-1.8b's FSDP
        # step shape ([lm_mesh]'s path), and at Qwen3-14B's width
        "flash_attention_bwd.f32": dict(
            bwd_times[("h2o-danube-1.8b", "float32")],
            qwen3=bwd_times[("Qwen3-14B", "float32")]),
        # and at d 256 (its blocks of its own): RecurrentGemma-9B's training
        # shape, and Gemma-7B's
        "flash_attention_bwd.f32_d256": dict(
            bwd_times[("RecurrentGemma-9B", "float32")],
            gemma=bwd_times[("Gemma-7B", "float32")]),
        # float16 on the tensor cores (f16_wgmma): at Qwen3-14B's width,
        # RecurrentGemma-9B's training shape beside it, the overflow case
        "flash_attention_bwd.f16": dict(
            bwd_times[("Qwen3-14B", "float16")],
            rg9b=bwd_times[("RecurrentGemma-9B", "float16")],
            overflow_finite=overflow),
        "f32_step_launches": {"flash_attention": 2,
                              "flash_attention_bwd": 1},
    }


def attention_bwd_timed(torch, dev, gen, card: str, name: str, dname: str,
                        b: int, hq: int, hkv: int, s: int, d: int,
                        window) -> dict:
    """The attention backward at one shape, on each route its dtype has
    here (bf16 / f16: ``bf16_wgmma`` / ``f16_wgmma`` with the forward's
    log-sum-exp, and ``bf16_simt`` / ``f16_simt``, forced by handing it q
    as a view at an odd element offset; f32: ``f32_3xtf32`` with the
    forward's log-sum-exp where d is one of TF32_HEAD_DIMS, and
    ``f32_simt``, without one): held to its plain version (float32 on the
    same inputs: rms error per head slice within the dtype's slice limit
    of HALF_LIMITS in bf16 and f16, BWD_F32_NRMS in f32) and to a second
    call of itself (bit for bit), ``f32_3xtf32`` also to float64 (at most
    TF32_VS_SIMT times ``f32_simt``'s error on the same inputs, per slice
    of 8 heads), and timed beside its bound, the plain version and SDPA's
    backward (a yardstick the port never calls: an explicit mask for a
    window); each tensor-core route must beat its dtype's CUDA-core route,
    ``bf16_wgmma`` and ``f16_wgmma`` the plain version too.  Returns the
    ``kernels`` line's numbers: those of the route the training step takes
    (of the tensor-core route in f16, with its launches in the checked
    calls, ``checked_launches``), and each route's time."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    dt = getattr(torch, dname)
    q = torch.randn((b, hq, s, d), generator=gen, device=dev).to(dt)
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dt)
            for _ in range(2))
    kw = dict(causal=True, window=window, scale=d ** -0.5)
    # the training forward: the log-sum-exp where the route hands it back
    out, lse = fa_ops._attend(q, k, v, lse=True, **kw)
    dout = torch.randn(out.shape, generator=gen, device=dev).to(dt)
    exp = fa_ref.attention_grad(q.float(), k.float(), v.float(),
                                dout.float(), **kw)
    limit = HALF_LIMITS[dname][2] if dname in HALF_LIMITS else BWD_F32_NRMS
    odd = odd_offset(q)
    calls = {fa_ops.bwd_route(dt, d, fa_ops._bwd_addresses(
        q, k, v, out, dout, lse)): (q, lse)}
    if dname in HALF_LIMITS:
        calls[fa_ops.bwd_route(dt, d, fa_ops._bwd_addresses(
            odd, k, v, out, dout, lse))] = (odd, lse)
        check(set(calls) == set(fa_ops.WGMMA_ROUTES[dt]),
              f"[train] attention backward {name}: routes {set(calls)}")
    elif d in fa_ops.TF32_HEAD_DIMS:
        # the CUDA-core route on the same operands: no log-sum-exp
        calls[fa_ops.bwd_route(dt, d, fa_ops._bwd_addresses(
            q, k, v, out, dout, None))] = (q, None)
        check(set(calls) == {"f32_3xtf32", "f32_simt"},
              f"[train] attention backward {name}: routes {set(calls)}")
    routes, grads, checked = {}, {}, {}
    for route, (qq, saved) in calls.items():
        fa_ops.flash_attention_bwd.routes = {}
        got = fa_ops.flash_attention_bwd(qq, k, v, out, dout, lse=saved,
                                         **kw)
        # no atomics: a second call gives the same bits
        again = fa_ops.flash_attention_bwd(qq, k, v, out, dout, lse=saved,
                                           **kw)
        check(fa_ops.flash_attention_bwd.routes == {route: 2},
              f"[train] attention backward {name} {dname}: launched "
              f"{fa_ops.flash_attention_bwd.routes}, expected {route}")
        checked[route] = fa_ops.flash_attention_bwd.routes[route]
        check(all(torch.equal(bits(torch, g), bits(torch, h))
                  for g, h in zip(got, again)),
              f"[train] attention backward {name} {dname} {route}: two "
              f"calls differ")
        del again
        nrms = max(slice_nrms(g, e) for g, e in zip(got, exp))
        err = max((g.double() - e.double()).abs().max().item()
                  for g, e in zip(got, exp))
        check(nrms <= limit, f"[train] attention backward {name} {dname} "
              f"{route}: rms error per head slice {nrms:.3e} (> "
              f"{limit:.3e})")
        if route.startswith("f32") and len(calls) > 1:
            grads[route] = got
        del got
        ms = time_ms(torch, lambda qq=qq, saved=saved:
                     fa_ops.flash_attention_bwd(qq, k, v, out, dout,
                                                lse=saved, **kw),
                     iters=20 if route.endswith("wgmma") else 5, warmup=1)
        routes[route] = dict(ms=ms, nrms=nrms, max_abs_err=err)
    if grads:
        # f32_3xtf32 against float64, beside f32_simt on the same inputs
        exact = attention_grad64(torch, fa_ref, q, k, v, dout, True, window)
        ratio = max(tf32_vs_simt(g, s_, x) for g, s_, x in zip(
            grads["f32_3xtf32"], grads["f32_simt"], exact))
        check(ratio <= TF32_VS_SIMT, f"[train] attention backward {name} "
              f"f32_3xtf32: {ratio:.2f} x f32_simt's float64 error (limit "
              f"{TF32_VS_SIMT})")
        routes["f32_3xtf32"]["vs_simt"] = ratio
        print(f"[train] attention backward {name} float32: f32_3xtf32 "
              f"against float64 at most {ratio:.2f} x f32_simt's error on "
              f"the same inputs per slice of 8 heads (limit "
              f"{TF32_VS_SIMT})")
        del exact
    grads.clear()
    del exp, odd
    plain_ms = time_ms(torch, lambda: fa_ref.attention_grad(
        q, k, v, dout, **kw), iters=2, warmup=1)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    if window is None:
        o = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=True, enable_gqa=True)
    else:
        seen = fa_ref.mask(s, s, causal=True, window=window, device=dev)
        o = torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=seen, enable_gqa=True)
    lib = time_ms(torch, lambda: torch.autograd.grad(
        o, leaves, dout, retain_graph=True), iters=5, warmup=1)
    flops = 10 * b * hq * d * visible_pairs(s, window)
    nbytes = 4 * (q.numel() + k.numel()) * q.element_size()
    bnd, by = bound_ms(nbytes, flops, dname)
    for route, r in routes.items():
        # f32_3xtf32's own bound: three TF32 products for each float32 one
        rb = (bound_ms(nbytes, TF32_PRODUCTS * flops, "tf32")[0]
              if route == "f32_3xtf32" else bnd)
        print(f"[train] attention backward {name} {dname} (q ({b}, {hq}, "
              f"{s}, {d}), k, v ({b}, {hkv}, {s}, {d}), window {window}, "
              f"{route}): {r['ms']:.3f} ms ({flops / r['ms'] / 1e9:.2f} "
              f"TFLOP/s of the 10 d FLOP a visible pair and head: the "
              f"bound is {100 * rb / r['ms']:.1f}% of the time), plain "
              f"{plain_ms:.3f} ms, SDPA's backward {lib:.3f} ms, bound "
              f"{rb:.4f} ms ({by}, {flops:.3e} FLOP); against the plain "
              f"version rms error per head slice {r['nrms']:.3e} (<= "
              f"{limit:.3e}), max_abs_err {r['max_abs_err']:.3e}; two calls "
              f"bit for bit equal ({card})")
    if dname in HALF_LIMITS:
        wgmma, simt = fa_ops.WGMMA_ROUTES[dt]
        fast = routes[wgmma]["ms"]
        check(fast < plain_ms and fast < routes[simt]["ms"],
              f"[train] attention backward {name}: {wgmma} {fast:.3f} ms "
              f"is not below the plain version ({plain_ms:.3f}) and "
              f"{simt} ({routes[simt]['ms']:.3f})")
    if "f32_3xtf32" in routes:
        fast = routes["f32_3xtf32"]["ms"]
        check(fast < routes["f32_simt"]["ms"], f"[train] attention backward "
              f"{name}: f32_3xtf32 {fast:.3f} ms is not below f32_simt "
              f"({routes['f32_simt']['ms']:.3f})")
    main_route = next(r for r in ("bf16_wgmma", "f16_wgmma", "f32_3xtf32",
                                  *routes) if r in routes)
    r = routes[main_route]
    # the 3xTF32 bound: three TF32 products for each float32 one
    tf32_bnd = (bound_ms(nbytes, TF32_PRODUCTS * flops, "tf32")[0]
                if main_route == "f32_3xtf32" else bnd)
    return dict(max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=plain_ms,
                bound_ms=tf32_bnd, bound_by=by, library_ms=lib,
                route_ms={k: v["ms"] for k, v in routes.items()},
                checked_launches=checked[main_route])


def f16_overflow_case(torch, dev, gen, card: str) -> dict:
    """A pinned divergence (ROADMAP Queue 3): ``f16_wgmma`` rounds dS = p
    (dp - delta) to float16 before dQ += dS K and dK += dS^T Q, where
    ``f16_simt`` keeps it in float32.  Scores near zero (q, k ~ 0.003)
    spread p over 1024 keys; |dout| ~ 1e4 and |v| ~ 1e3 put |dp - delta|
    near 1e8 and |dS| past 65504, while every true gradient stays below
    1e4.  Runs both routes and the plain version (float32 inside) on the
    same values, prints which give finite dq, dk, dv, and checks the
    pinned outcome: the plain version and ``f16_simt`` finite,
    ``f16_wgmma``'s dq and dk not, its dv (from P alone) finite."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    b, h, s, d = 1, 2, 1024, 128
    dt = torch.float16
    q, k = (3e-3 * torch.randn((b, h, s, d), generator=gen, device=dev)
            for _ in range(2))
    v = 1e3 * torch.randn((b, h, s, d), generator=gen, device=dev)
    dout = 1e4 * torch.randn((b, h, s, d), generator=gen, device=dev)
    q, k, v, dout = (x.to(dt) for x in (q, k, v, dout))
    kw = dict(causal=False, window=None, scale=d ** -0.5)
    out, lse = fa_ops._attend(q, k, v, lse=True, **kw)
    finite = {}
    for route, qq, saved in (("f16_wgmma", q, lse),
                             ("f16_simt", odd_offset(q), None)):
        fa_ops.flash_attention_bwd.routes = {}
        got = fa_ops.flash_attention_bwd(qq, k, v, out, dout, lse=saved, **kw)
        check(fa_ops.flash_attention_bwd.routes == {route: 1},
              f"[train] f16 overflow case: launched "
              f"{fa_ops.flash_attention_bwd.routes}, expected {route}")
        finite[route] = [bool(torch.isfinite(g).all()) for g in got]
    plain = fa_ref.attention_grad(q, k, v, dout, **kw)
    finite["plain"] = [bool(torch.isfinite(g).all()) for g in plain]
    largest = [g.float().abs().max().item() for g in plain]
    print(f"[train] f16 overflow case (q, k ~ 3e-3, v ~ 1e3, dout ~ 1e4, "
          f"({b}, {h}, {s}, {d}), non-causal): dq, dk, dv finite: "
          + "; ".join(f"{r} {f}" for r, f in finite.items())
          + f"; the plain version's largest |dq|, |dk|, |dv| "
          f"{largest[0]:.1f}, {largest[1]:.1f}, {largest[2]:.1f} ({card})")
    check(finite["plain"] == finite["f16_simt"] == [True] * 3
          and finite["f16_wgmma"] == [False, False, True],
          f"[train] f16 overflow case: finite dq, dk, dv {finite}, expected "
          f"the pinned divergence (f16_wgmma's dq and dk not finite)")
    return finite


# the rest of the LM stack: granite-moe-3b-a800m served at its published
# widths and depth (src/repro/configs/granite_moe_3b_a800m.py), bf16, random
# weights from SEED; B prompts of S tokens, then greedy decode steps
MOE_ARCH = "granite_moe_3b_a800m"
MOE_PARAMS = 3_298_693_632             # count_params
MOE_ACTIVE = 882_774_528               # active_param_count: 8 of 40 experts
MOE_BATCH, MOE_PROMPT, MOE_DECODE = 2, 4096, 32
# decode steps of the profiled decode run (the host-bound steps repeat:
# the first 8 of the 32 served show where a step's device time goes)
MOE_PROFILE_DECODE = 8
# one flash_attention launch a layer a prefill, on the tensor cores (d 64)
MOE_KERNELS = {"bf16_wgmma": 32}
# the reference's serving check in float32 at 2 layers, with a capacity
# that drops no token (C = T, as reduced() sets it: decode never drops, so
# a forward that dropped tokens would differ from decode by design)
FAM_TF_LAYERS, FAM_TF_PROMPT, FAM_TF_DECODE = 2, 1024, 8
# the other four families at their published widths: (arch, depth or None
# for the published one, encoder frames a prompt, text tokens a prompt,
# flash_attention launches by route a prefill, whether to serve cold
# before the counted run).  Moonshot's 28.06 B parameters (56 GB in bf16)
# do not fit beside the rest of the script: its depth is cut to 4 of 48
# layers
FAMILIES = (
    ("moonshot_v1_16b_a3b", 4, 0, 4096, {"bf16_wgmma": 4}, True),
    # 12 encoder (non-causal), 12 decoder (causal), 12 cross-attention
    # (non-causal, 4096 queries over 1024 keys)
    ("seamless_m4t_medium", None, 1024, 4096, {"bf16_wgmma": 36}, True),
    # 64 image patches + 4032 text tokens; d 96 takes the tensor cores
    ("phi_3_vision_4_2b", None, 0, 4032, {"bf16_wgmma": 32}, True),
    # mLSTM and sLSTM blocks: no attention, no kernel.  The sLSTM's
    # host-bound Python loop (17 s a prefill at 24 layers) is as warm in
    # its first run as in a second, so it is served once, and at a quarter
    # of the depth (3 of 12 pattern periods), which leaves room for
    # [lm_mesh] in the script's time
    ("xlstm_350m", 6, 0, 4096, {}, False),
)
FAM_BATCH, FAM_DECODE = 2, 8
# training each of the five at its published widths, one pattern period or
# two layers deep (Seamless one encoder and one decoder layer): B 1 x S
# 2048 positions (Phi-3's 64 patches among them), bf16, remat, AdamW;
# flash_attention (forward twice with remat) and its backward by route a
# step
TRAIN_FAMILIES = (
    ("granite_moe_3b_a800m", dict(n_layers=2),
     {"bf16_wgmma": 4}, {"bf16_wgmma": 2}),
    ("moonshot_v1_16b_a3b", dict(n_layers=2),
     {"bf16_wgmma": 4}, {"bf16_wgmma": 2}),
    ("seamless_m4t_medium", dict(n_layers=1, encoder_layers=1),
     {"bf16_wgmma": 6}, {"bf16_wgmma": 3}),
    ("phi_3_vision_4_2b", dict(n_layers=2),
     {"bf16_wgmma": 4}, {"bf16_wgmma": 2}),
    ("xlstm_350m", dict(n_layers=2), {}, {}),
)
TRAIN_FAM_SEQ, TRAIN_FAM_STEPS = 2048, 3
# xLSTM's sLSTM loop is one Python step a token: two steps keep every
# check of the phase (step 1's gradients, the launches every step) at a
# third less of its time
TRAIN_FAM_STEPS_OF = {"xlstm_350m": 2}
# Gemma-7B at its published widths in float32 (src/repro/configs/
# gemma_7b.py: d_model 3072, 16 / 16 heads at d 256, causal, vocab 256000),
# depth cut to 2 of 28 layers (1,340,080,128 parameters in weight
# matrices: ~21.5 GB of weights, gradients and AdamW moments, ~4.2 GB a
# logits-sized tensor); B 1 x S 4096, GEMMA_F32_STEPS AdamW steps through
# make_train_step, remat: a step launches the attention forward twice a
# layer and its backward once, both f32_3xtf32 (d 256's blocks)
GEMMA_F32_ARCH, GEMMA_F32_LAYERS = "gemma_7b", 2
GEMMA_F32_NAME = "gemma-7b float32"    # its [train_families] key
GEMMA_F32_SEQ, GEMMA_F32_STEPS = 4096, 3
GEMMA_F32_KERNELS = {"flash_attention": {"f32_3xtf32": 4},
                     "flash_attention_bwd": {"f32_3xtf32": 2}}
# attention at the shapes the new families give it, timed beside its bound,
# its plain version and SDPA (forward and backward): (B, Hq, Hkv, Sq, Skv,
# D, causal)
FAMILY_ATTN = {
    "Granite-MoE-3B (24/8, d 64)": (2, 24, 8, 4096, 4096, 64, True),
    "Seamless cross (16/16, Sq 4096 / Skv 1024)": (2, 16, 16, 4096, 1024,
                                                   64, False),
    "Phi-3-vision (32/32, d 96)": (2, 32, 32, 4096, 4096, 96, True),
    "h2o-danube (32/8, d 80)": (2, 32, 8, 4096, 4096, 80, True),
}
# the families' shapes that also run in float16, both ways on f16_wgmma:
# d 64, 80 and 96 (its last 64-column panel of 16 / 32 real columns)
FAMILY_F16 = ("Granite-MoE-3B (24/8, d 64)", "Phi-3-vision (32/32, d 96)",
              "h2o-danube (32/8, d 80)")
# float32 attention at the shape [lm_mesh]'s FSDP step gives it (the
# whole batch of h2o-danube-1.8b, 8 x 1024, window 4096): the training
# forward on f32_3xtf32, timed beside f32_simt on the same values, its
# bound, its plain version and SDPA's; (B, Hq, Hkv, S, D, window)
FAMILY_F32_ATTN = {"h2o-danube-1.8b (32/8, d 80, [lm_mesh]'s FSDP step)":
                   (8, 32, 8, 1024, 80, 4096)}


def _moe_ranges(moe_mod):
    """Wrap the mixture-of-experts stages in profiler ranges; returns the
    originals to restore."""
    import torch

    originals = {}
    for name, fn in (("_route", moe_mod._route),
                     ("_dispatch", moe_mod._dispatch),
                     ("_expert_ffn", moe_mod._expert_ffn),
                     ("_combine", moe_mod._combine)):
        def ranged(*args, _fn=fn, _name=f"moe{name}", **kwargs):
            with torch.profiler.record_function(_name):
                return _fn(*args, **kwargs)
        originals[name] = fn
        setattr(moe_mod, name, ranged)
    return originals


MOE_RANGES = ("moe_route", "moe_dispatch", "moe_expert_ffn", "moe_combine")


def lm_moe_phase(torch, dev, gen, card: str, zero_counts, counts) -> dict:
    """``[lm_moe]``: serve granite-moe-3b-a800m at its published widths and
    depth on the card through the port's entry points; check the kernel
    launches, hold every attention call of a prefill to its plain version,
    read the balance loss and the tokens each layer's capacity drops, check
    decode against the full sequence in float32, and print the walls,
    rates, bounds, where the device time goes (the MoE stages apart) and
    the memory.  Returns the ``kernels`` line's additions."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.linear_scan import ref as ls_ref
    from repro_torch.models import LanguageModel, attention_xla
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.blocks import count_params
    from repro_torch.train import make_decode_step, make_prefill_step

    base = memory_base(torch, dev)
    cfg = configs.get(MOE_ARCH)
    t0 = time.perf_counter()
    model = LanguageModel(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_matrix = model.param_count()
    check(n_matrix == count_params(cfg) == MOE_PARAMS
          and count_params(cfg, active_only=True) == MOE_ACTIVE,
          f"[lm_moe] {n_matrix} parameters in weight matrices, "
          f"count_params {count_params(cfg)}, expected {MOE_PARAMS}")
    kinds = [kind for _, kind in model.layers()]
    check(kinds == ["attn"] * 32, f"[lm_moe] layers {kinds}")
    routers = [p.dtype for n, p in model.named_parameters()
               if n.endswith("moe.router")]
    check(routers == [torch.float32] * 32,
          f"[lm_moe] the routers' dtypes {routers}")
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"[lm_moe] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, "
          f"head_dim {cfg.head_dim}, {cfg.n_experts} experts top-"
          f"{cfg.n_experts_active}, expert d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, tied, {model.dtype} (routers float32); "
          f"{n_matrix:,} parameters in weight matrices (= count_params), "
          f"{MOE_ACTIVE:,} active a token; {w_bytes:,} bytes; drawn on the "
          f"card from seed {SEED} in {t_init:.3f} s ({card})")

    b, s, n_dec = MOE_BATCH, MOE_PROMPT, MOE_DECODE
    prefill = make_prefill_step(model, s_max=s + n_dec)
    decode = make_decode_step(model)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    plain = {"attention": 0, "attention_lse": 0, "linear_scan": 0}
    originals = {"attention": fa_ref.attention,
                 "attention_lse": fa_ref.attention_lse,
                 "linear_scan": ls_ref.linear_scan}

    def counting(name):
        def wrapper(*args, **kwargs):
            plain[name] += 1
            return originals[name](*args, **kwargs)
        return wrapper

    for name, mod in (("attention", fa_ref), ("attention_lse", fa_ref),
                      ("linear_scan", ls_ref)):
        setattr(mod, name, counting(name))
    try:
        cold = served(torch, prefill, decode, tokens, {}, 0, n_dec,
                      "[lm_moe]", cfg.vocab_size)
        zero_counts()
        for key in plain:
            plain[key] = 0
        generated, t_prefill, t_decode = served(
            torch, prefill, decode, tokens, {}, 0, n_dec, "[lm_moe]",
            cfg.vocab_size)
        got = counts()
        routes = dict(fa_ops.flash_attention.routes)
    finally:
        fa_ref.attention = originals["attention"]
        fa_ref.attention_lse = originals["attention_lse"]
        ls_ref.linear_scan = originals["linear_scan"]
    check(torch.equal(generated, cold[0]), "[lm_moe] two served runs of the "
          "same prompt generated different tokens")
    check(got["flash_attention"] == 32 and routes == MOE_KERNELS,
          f"[lm_moe] flash_attention: {got['flash_attention']} launches by "
          f"route {routes}, expected {MOE_KERNELS} a prefill")
    others = {k: v for k, v in got.items() if v and k != "flash_attention"}
    check(not others, f"[lm_moe] unexpected launches {others}")
    check(not any(plain.values()), f"[lm_moe] plain versions called {plain}")
    print(f"[lm_moe] served run: {got['flash_attention']} flash_attention "
          f"launches on {routes}, no other kernel wrapper, no plain version "
          f"called; two served runs gave the same {tuple(generated.shape)} "
          f"tokens")

    # bounds: the active weights' FLOPs (the embedding is a lookup), the
    # attention's visible pairs, the head at the last position; a decode
    # step reads every weight (its buffer covers all 40 experts)
    active = MOE_ACTIVE - cfg.vocab_size * cfg.d_model
    pre_flops = 2 * active * b * s
    attn_flops = 4 * cfg.n_heads * cfg.head_dim * b * visible_pairs(
        s, None) * cfg.n_layers
    head_flops = 2 * b * cfg.d_model * cfg.vocab_size
    pre_bound = (pre_flops + attn_flops + head_flops) / PEAK_FLOPS[
        "bfloat16"] * 1e3
    dec_bound = w_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[lm_moe] prefill {b} x {s} tokens: cold {cold[1]:.4f} s, warm "
          f"{t_prefill:.4f} s, {b * s / t_prefill:.1f} tokens/s; bound "
          f"{pre_bound:.3f} ms (({pre_flops:.4e} active-weight + "
          f"{attn_flops:.4e} attention + {head_flops:.4e} head) FLOP at 989 "
          f"TFLOP/s bf16), {pre_bound / 1e3 / t_prefill * 100:.1f}% of it "
          f"({card})")
    print(f"[lm_moe] decode {n_dec} steps x {b}: cold {cold[2]:.4f} s, warm "
          f"{t_decode:.4f} s, {t_decode / n_dec * 1e3:.3f} ms a step, "
          f"{b * n_dec / t_decode:.1f} tokens/s; bound {dec_bound:.3f} ms a "
          f"step ({w_bytes:,} weight bytes at 3.35 TB/s), "
          f"{dec_bound / (t_decode / n_dec * 1e3) * 100:.1f}% of it ({card})")

    # -- where the device time goes, the MoE stages apart --------------------
    moe_originals = _moe_ranges(moe_mod)
    try:
        pre_kernels, _ = profile_classes(
            torch, "[lm_moe] prefill", lambda: prefill(tokens), t_prefill,
            {"flash_attention_wgmma_kernel": 32}, MOE_RANGES)
        _, states = prefill(tokens)
        token = generated[:, :1]

        def decode_run():
            st = states
            for t in range(MOE_PROFILE_DECODE):
                _, st = decode(st, token, s + t)

        # the busy share against the served run's wall for as many steps
        profile_classes(torch, f"[lm_moe] decode ({MOE_PROFILE_DECODE} "
                        f"steps)", decode_run,
                        t_decode * MOE_PROFILE_DECODE / n_dec,
                        {"flash_attention": 0}, MOE_RANGES)
        del states
    finally:
        for name, fn in moe_originals.items():
            setattr(moe_mod, name, fn)
    attn_ms = sum(m for m, _n, k in pre_kernels
                  if "flash_attention_wgmma_kernel" in k)
    print(f"[lm_moe] flash_attention_wgmma_kernel inside the served prefill: "
          f"{attn_ms:.3f} ms for 32 launches, {attn_ms / 32:.4f} ms each "
          f"({card})")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[lm_moe] peak device memory {peak:,} bytes with {w_bytes:,} of "
          f"weights ({card})")

    # -- one more prefill: every attention call held, aux and drops read -----
    held = AttentionHeld(torch, fa_ops, fa_ref,
                         attention_xla.flash_attention, "[lm_moe]")
    aux, drops = [], []
    layer_fn, dispatch_fn = moe_mod.moe_layer, moe_mod._dispatch

    def layer_read(p, x, cfg_):
        y, a = layer_fn(p, x, cfg_)
        aux.append(a.item())
        return y, a

    def dispatch_read(x, top_i, top_w, E, C):
        buf, meta = dispatch_fn(x, top_i, top_w, E, C)
        drops.append(int((~meta[3]).sum()))
        return buf, meta

    attention_xla.flash_attention = held
    moe_mod.moe_layer, moe_mod._dispatch = layer_read, dispatch_read
    try:
        t0 = time.perf_counter()
        prefill(tokens)
        torch.cuda.synchronize()
    finally:
        attention_xla.flash_attention = held.original
        moe_mod.moe_layer, moe_mod._dispatch = layer_fn, dispatch_fn
    check(held.calls == {(True, s, s): 32}, f"[lm_moe] held {held.calls}")
    check(len(aux) == 32 and all(math.isfinite(a) and a > 0 for a in aux),
          f"[lm_moe] aux per layer {aux}")
    capacity = moe_mod._capacity(b * s, cfg)
    print(f"[lm_moe] every attention call of one prefill against its plain "
          f"version ({time.perf_counter() - t0:.3f} s): {held.summary()}")
    print(f"[lm_moe] balance loss aux: {sum(aux):.4f} over the 32 layers "
          f"(each {min(aux):.4f}-{max(aux):.4f}; 1 is a uniform router); "
          f"(token, slot) pairs dropped at each layer's capacity C = "
          f"{capacity} of {b * s * cfg.n_experts_active}: {drops} "
          f"({sum(drops)} in all)")
    del model, prefill, decode, tokens, generated, cold, held
    memory_back(torch, dev, base, "[lm_moe] the bf16 model")

    line = teacher_forcing(torch, dev, gen, cfg, "[lm_moe]", zero_counts,
                           counts)
    print(line)
    memory_back(torch, dev, base, "[lm_moe] the phase")
    return {"name": cfg.name, "launches": 32, "route": "bf16_wgmma",
            "ms": attn_ms / 32}


def lm_families_phase(torch, dev, gen, card: str, zero_counts,
                      counts) -> dict:
    """``[lm_families]``: serve Moonshot (4 layers), Seamless, Phi-3-vision
    and xLSTM at their published widths on the card, each a prefill and
    FAM_DECODE greedy decode steps, cold then warm; check the attention
    launches by route, hold every attention call of one more prefill to
    its plain version, time the sLSTM's loop, check decode against the full
    sequence in float32 at a small depth, and print walls, rates and
    memory.  Returns, per family, its launches by route a prefill."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import LanguageModel, attention_xla, xlstm
    from repro_torch.models.blocks import count_params
    from repro_torch.train import make_decode_step, make_prefill_step

    out = {}
    for arch, depth, enc_len, n_text, want, twice in FAMILIES:
        base = memory_base(torch, dev)
        full = configs.get(arch)
        cfg = full if depth is None else dataclasses.replace(
            full, n_layers=depth)
        label = f"[lm_families] {cfg.name}"
        model = LanguageModel(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(SEED))
        n_matrix = model.param_count()
        check(n_matrix == count_params(cfg), f"{label}: param_count "
              f"{n_matrix}, count_params {count_params(cfg)}")
        kinds = [kind for _, kind in model.layers()]
        n_img = cfg.vision_tokens if cfg.frontend == "vision" else 0
        print(f"{label}: {cfg.n_layers} layers"
              + (f" of {full.n_layers}" if depth is not None else "")
              + (f" + {cfg.encoder_layers} encoder layers"
                 if cfg.encoder_layers else "")
              + f" ({', '.join(sorted(set(kinds)))}), d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads over {cfg.n_kv_heads}, head_dim "
              f"{cfg.head_dim_}, vocab {cfg.vocab_size}, {model.dtype}; "
              f"{n_matrix:,} parameters in weight matrices (= count_params"
              f"{'; the published depth has ' + format(full.param_count(), ',') if depth is not None else ''}) "
              f"({card})")
        b = FAM_BATCH
        s_max = n_img + n_text + FAM_DECODE
        prefill = make_prefill_step(model, s_max=s_max)
        decode = make_decode_step(model)
        tokens = torch.randint(0, cfg.vocab_size, (b, n_text), generator=gen,
                               device=dev)
        ext = front_ends(torch, cfg, gen, dev, b, enc_len)
        slstm_events = []
        slstm_fn = xlstm.slstm_block

        def slstm_timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = slstm_fn(*args, **kwargs)
            end.record()
            slstm_events.append((start, end))
            return result

        cold = served(torch, prefill, decode, tokens, ext, n_img, FAM_DECODE,
                      label, cfg.vocab_size) if twice else None
        zero_counts()
        xlstm.slstm_block = slstm_timed
        try:
            generated, t_pre, t_dec = served(
                torch, prefill, decode, tokens, ext, n_img, FAM_DECODE, label,
                cfg.vocab_size)
        finally:
            xlstm.slstm_block = slstm_fn
        got = counts()
        routes = dict(fa_ops.flash_attention.routes)
        peak = torch.cuda.max_memory_allocated(dev)
        check(cold is None or torch.equal(generated, cold[0]),
              f"{label}: two served runs generated different tokens")
        check(routes == want and got["flash_attention"] == sum(want.values()),
              f"{label}: flash_attention launches by route {routes}, "
              f"expected {want} a prefill")
        others = {k: v for k, v in got.items() if v and k != "flash_attention"}
        check(not others, f"{label}: unexpected launches {others}")
        positions = b * (n_img + n_text)
        print(f"{label}: prefill {b} x ({n_img} patches + {n_text} tokens"
              + (f", {enc_len} encoder frames" if enc_len else "")
              + (f"): cold {cold[1]:.4f} s, warm" if cold else "): once")
              + f" {t_pre:.4f} s, "
              f"{positions / t_pre:.1f} positions/s; decode {FAM_DECODE} "
              f"steps: {t_dec:.4f} s, {t_dec / FAM_DECODE * 1e3:.3f} ms "
              f"a step, {b * FAM_DECODE / t_dec:.1f} tokens/s; launches "
              f"{routes or 'none'} a prefill, no other kernel wrapper; peak "
              f"device memory {peak:,} bytes ({card})")
        if slstm_events:
            torch.cuda.synchronize()
            per = [a.elapsed_time(e) for a, e in slstm_events]
            print(f"{label}: the sLSTM's Python loop over {n_text} tokens, "
                  f"{len(per)} layers: {sum(per):.1f} ms of the "
                  f"{t_pre * 1e3:.1f} ms prefill, "
                  f"{statistics.median(per) / n_text:.4f} ms a token a layer "
                  f"(median layer; CUDA events) ({card})")
        if want:
            held = AttentionHeld(torch, fa_ops, fa_ref,
                                 attention_xla.flash_attention, label)
            attention_xla.flash_attention = held
            try:
                prefill(tokens, **ext)
                torch.cuda.synchronize()
            finally:
                attention_xla.flash_attention = held.original
            check(sum(held.calls.values()) == sum(want.values()),
                  f"{label}: held {held.calls}")
            print(f"{label}: every attention call of one prefill against its "
                  f"plain version: {held.summary()}")
            del held
        out[cfg.name] = {"launches": sum(want.values()),
                         "routes": dict(want)}
        del model, prefill, decode, tokens, ext, generated, cold
        slstm_events.clear()
        memory_back(torch, dev, base, f"{label} the bf16 model")
        print(teacher_forcing(torch, dev, gen, full, label, zero_counts,
                              counts))
        memory_back(torch, dev, base, label)
    return out


def train_families_phase(torch, dev, card: str, zero_counts,
                         counts) -> dict:
    """``[train_families]``: train each of the five new families at its
    published widths (TRAIN_FAMILIES' depths), bf16, B 1 x S
    TRAIN_FAM_SEQ, remat, TRAIN_FAM_STEPS AdamW steps (TRAIN_FAM_STEPS_OF
    where a family takes fewer) through
    ``make_train_step``; check the losses, step 1's gradients (finite and
    non-zero for every parameter), the attention launches and backward
    launches by route every step, step 1's attention backward calls
    against ``ref.attention_grad`` (rms error per head slice within
    BF16_SLICE_NRMS), and the memory.  Returns the backward's launches a
    step per family."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import LanguageModel
    from repro_torch.models.blocks import count_params
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train import make_train_step

    backward = fa_ops._Attention.__dict__["backward"]
    out = {}
    for arch, over, want_fwd, want_bwd in TRAIN_FAMILIES:
        base = memory_base(torch, dev)
        cfg = dataclasses.replace(configs.get(arch), **over)
        label = f"[train_families] {cfg.name}"
        model = LanguageModel(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(SEED))
        n_params = model.param_count()
        check(n_params == count_params(cfg), f"{label}: param_count")
        n_img = cfg.vision_tokens if cfg.frontend == "vision" else 0
        data = SyntheticLMDataset(
            cfg.vocab_size, TRAIN_FAM_SEQ - n_img, 1, seed=SEED,
            enc_len=(TRAIN_FAM_SEQ // cfg.encoder_ratio
                     if cfg.encoder_layers else 0),
            d_model=cfg.d_model if (cfg.encoder_layers or cfg.frontend)
            else 0, vision_tokens=n_img, device=dev)
        first, held = {}, {"calls": 0, "nrms": 0.0, "shapes": set()}
        holding = [False]

        class Watching(AdamW):
            def update(self, grads, state, params):
                if state.count == 0:
                    for name, g in grads.items():
                        first[name] = (bool(torch.isfinite(g).all()),
                                       g.float().abs().max().item())
                return super().update(grads, state, params)

        def bwd_held(ctx, dout):
            q, k, v, o, lse = ctx.saved_tensors
            causal, window, scale = ctx.mask
            got = fa_ops.flash_attention_bwd(q, k, v, o, dout, lse=lse,
                                             causal=causal, window=window,
                                             scale=scale)
            if holding[0]:
                exp = fa_ref.attention_grad(
                    q.float(), k.float(), v.float(), dout.float(),
                    causal=causal, window=window, scale=scale)
                for name, g, e in zip(("dq", "dk", "dv"), got, exp):
                    nrms = slice_nrms(g, e)
                    check(bool(torch.isfinite(g).all())
                          and nrms <= BF16_SLICE_NRMS,
                          f"{label} attention backward {name} "
                          f"({'causal' if causal else 'non-causal'} Sq "
                          f"{q.shape[2]} Skv {k.shape[2]}): rms error per "
                          f"head slice {nrms:.3e} (> {BF16_SLICE_NRMS:.3e})")
                    held["nrms"] = max(held["nrms"], nrms)
                held["calls"] += 1
                held["shapes"].add((causal, q.shape[2], k.shape[2]))
            return (*got, None, None, None, None)

        steps = TRAIN_FAM_STEPS_OF.get(arch, TRAIN_FAM_STEPS)
        opt = Watching(learning_rate=warmup_cosine(1e-3, 1, steps))
        state = opt.init(model)
        step = make_train_step(model, opt)
        losses, walls = [], []
        fa_ops._Attention.backward = staticmethod(bwd_held)
        try:
            zero_counts()
            for i in range(steps):
                holding[0] = i == 0
                batch = data.batch_at(i)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                losses.append(float(metrics["loss"]))
                if i == 0:
                    aux = float(metrics["aux"])
            holding[0] = False
            got = counts()
            routes = {"flash_attention": dict(fa_ops.flash_attention.routes),
                      "flash_attention_bwd":
                          dict(fa_ops.flash_attention_bwd.routes)}
        finally:
            fa_ops._Attention.backward = backward
        peak = torch.cuda.max_memory_allocated(dev)
        check(all(math.isfinite(x) for x in losses), f"{label}: losses "
              f"{losses}")
        check(not cfg.is_moe or (math.isfinite(aux) and aux > 0),
              f"{label}: aux {aux}")
        names = [n for n, _ in model.named_parameters()]
        bad = [n for n in names if n not in first or not first[n][0]
               or first[n][1] == 0.0]
        check(not bad, f"{label}: step 1 zero, missing or non-finite "
              f"gradients {bad[:8]}")
        want = {"flash_attention": {r: n * steps for r, n in want_fwd.items()},
                "flash_attention_bwd": {r: n * steps
                                        for r, n in want_bwd.items()}}
        check(routes == want, f"{label}: launches by route {routes}, "
              f"expected {want} over {steps} steps")
        others = {k: v for k, v in got.items()
                  if v and k not in ("flash_attention", "flash_attention_bwd")}
        check(not others, f"{label}: unexpected launches {others}")
        check(held["calls"] == sum(want_bwd.values()),
              f"{label}: step 1 held {held['calls']} attention backwards, "
              f"expected {sum(want_bwd.values())}")
        shapes = ", ".join(f"{'causal' if c else 'non-causal'} Sq {a} Skv {k}"
                           for c, a, k in sorted(held["shapes"]))
        print(f"{label}: {cfg.n_layers} layers"
              + (f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers
                 else "")
              + f" at the published widths, {n_params:,} parameters in "
              f"weight matrices; B 1 x S {TRAIN_FAM_SEQ}"
              + (f" ({n_img} patches)" if n_img else "")
              + f", remat: losses {', '.join(f'{x:.4f}' for x in losses)}"
              + (f" (aux {aux:.4f} at step 1)" if cfg.is_moe else "")
              + f"; step walls {', '.join(f'{w:.4f}' for w in walls)} s; "
              f"every parameter's gradient finite and non-zero at step 1; "
              f"launches a step {want_fwd or 'none'} forward, "
              f"{want_bwd or 'none'} backward; step 1's {held['calls']} "
              f"attention backwards [{shapes}] within {held['nrms']:.3e} rms "
              f"per head slice of the plain version (<= "
              f"{BF16_SLICE_NRMS:.3e}); peak device memory {peak:,} bytes "
              f"({card})")
        out[cfg.name] = {"bwd_launches": sum(want_bwd.values()),
                         "bwd_routes": dict(want_bwd)}
        del model, state, step, opt, data, metrics, batch
        first.clear()
        memory_back(torch, dev, base, label)
    gemma = gemma_f32_train(torch, dev, card, zero_counts, counts)
    out[gemma["name"]] = gemma
    return out


def gemma_f32_train(torch, dev, card: str, zero_counts, counts) -> dict:
    """Gemma-7B trained in float32 at its published widths
    (GEMMA_F32_LAYERS of its 28 layers), B 1 x S GEMMA_F32_SEQ: step 1's
    loss and every gradient through the kernels held within
    TRAIN_F32_TOL of the same step on the plain versions (on the card, no
    kernel launched), then GEMMA_F32_STEPS AdamW steps through
    ``make_train_step``, each launching GEMMA_F32_KERNELS (f32_3xtf32
    both ways, no plain version), timed; model FLOP/s, peak memory, one
    more step profiled.  Returns the step's numbers."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import LanguageModel
    from repro_torch.models.blocks import count_params
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train import make_train_step

    base = memory_base(torch, dev)
    cfg = dataclasses.replace(configs.get(GEMMA_F32_ARCH),
                              n_layers=GEMMA_F32_LAYERS, dtype="float32")
    label = f"[train_families] {cfg.name} float32"
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
           cfg.vocab_size) == (3072, 16, 16, 256, 256000),
          f"{label}: widths {cfg}")
    check(fa_ops.route(torch.float32, cfg.head_dim) == "f32_3xtf32"
          and fa_ops.bwd_route(torch.float32, cfg.head_dim) == "f32_3xtf32",
          f"{label}: d {cfg.head_dim} is not on f32_3xtf32 both ways")
    model = LanguageModel(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    n_params = model.param_count()
    check(n_params == count_params(cfg), f"{label}: param_count")
    data = SyntheticLMDataset(cfg.vocab_size, GEMMA_F32_SEQ, 1, seed=SEED,
                              device=dev)
    model.requires_grad_(True)
    batch = data.batch_at(0)

    def loss_and_grads():
        loss, _ = model.loss(batch)
        loss.backward()
        grads = {}
        for name, p in model.named_parameters():
            grads[name], p.grad = p.grad, None
        return loss.detach(), grads

    # -- step 1 through the kernels, then on the plain versions -------------
    fa_ops.flash_attention.routes = {}
    fa_ops.flash_attention_bwd.routes = {}
    zero_counts()
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    got = counts()
    routes = {"flash_attention": dict(fa_ops.flash_attention.routes),
              "flash_attention_bwd": dict(fa_ops.flash_attention_bwd.routes)}
    check(routes == GEMMA_F32_KERNELS
          and not {k: v for k, v in got.items()
                   if v and k not in GEMMA_F32_KERNELS},
          f"{label}: step 1 launched {got}, routes {routes}")

    def attend_plain(q, k, v, *, causal, window, scale, lse):
        return fa_ref.attention(q, k, v, causal=causal, window=window,
                                scale=scale), None

    def bwd_plain(q, k, v, out, dout, lse=None, **kw):
        return fa_ref.attention_grad(q, k, v, dout, **kw)

    kernel_fns = (fa_ops._attend, fa_ops.flash_attention_bwd)
    fa_ops._attend, fa_ops.flash_attention_bwd = attend_plain, bwd_plain
    try:
        zero_counts()
        loss_p, grads_p = loss_and_grads()
        torch.cuda.synchronize()
        got = counts()
    finally:
        fa_ops._attend, fa_ops.flash_attention_bwd = kernel_fns
    check(not any(got.values()), f"{label}: the plain step launched {got}")
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    check(loss_err <= TRAIN_F32_TOL, f"{label}: loss {loss_k.item()} "
          f"through the kernels, {loss_p.item()} plain")
    worst, worst_name = 0.0, None
    for name, gp in grads_p.items():
        rel = ((grads_k[name] - gp).abs().max()
               / gp.abs().max().clamp_min(1e-30)).item()
        check(math.isfinite(rel) and rel <= TRAIN_F32_TOL
              and gp.abs().max().item() > 0,
              f"{label}: gradient {name}: largest difference {rel:.3e} of "
              f"its largest |value| (> {TRAIN_F32_TOL})")
        if rel >= worst:
            worst, worst_name = rel, name
    print(f"{label}: step 1 loss {loss_k.item():.6f} through the kernels, "
          f"{loss_p.item():.6f} on the plain versions (relative difference "
          f"{loss_err:.3e}); all {len(grads_p)} gradients non-zero and "
          f"within {TRAIN_F32_TOL} of their largest |value| (worst "
          f"{worst:.3e}, {worst_name}); launches {routes}")
    del grads_k, grads_p, gp, loss_k, loss_p
    gc.collect()

    # -- GEMMA_F32_STEPS steps through make_train_step -----------------------
    opt = AdamW(learning_rate=warmup_cosine(1e-3, 1, GEMMA_F32_STEPS))
    state = opt.init(model)
    step = make_train_step(model, opt)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, walls = [], []
    fa_ops.flash_attention.routes = {}
    fa_ops.flash_attention_bwd.routes = {}
    zero_counts()
    for i in range(GEMMA_F32_STEPS):
        batch = data.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    got = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    routes = {"flash_attention": dict(fa_ops.flash_attention.routes),
              "flash_attention_bwd": dict(fa_ops.flash_attention_bwd.routes)}
    want = {k: {r: n * GEMMA_F32_STEPS for r, n in v.items()}
            for k, v in GEMMA_F32_KERNELS.items()}
    check(routes == want and not {k: v for k, v in got.items()
                                  if v and k not in want},
          f"{label}: {GEMMA_F32_STEPS} steps launched {got}, routes "
          f"{routes}, expected {want}")
    check(all(math.isfinite(x) for x in losses), f"{label}: losses {losses}")
    warm = statistics.median(walls[1:])
    tokens = GEMMA_F32_SEQ
    model_flops = 6 * n_params * tokens
    print(f"{label}: {cfg.n_layers} of 28 layers at the published widths, "
          f"{n_params:,} parameters in weight matrices; B 1 x S "
          f"{GEMMA_F32_SEQ}, remat, AdamW: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; step walls "
          f"{', '.join(f'{w:.4f}' for w in walls)} s, warm (median of steps "
          f"2-{GEMMA_F32_STEPS}) {warm:.4f} s, {tokens / warm:.1f} tokens/s, "
          f"model FLOP/s {model_flops / warm / 1e12:.2f} TFLOP/s (6 N T = "
          f"{model_flops:.4e}); peak device memory {peak:,} bytes; launches "
          f"{routes} ({card})")
    batch = data.batch_at(GEMMA_F32_STEPS)
    found = {}

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    busy = device_profile(
        torch, label, one_step, warm,
        {"flash_attention_tf32_kernel": 4,
         "attention_bwd_dq_tf32_kernel": 2,
         "attention_bwd_dkv_tf32_kernel": 4,
         "attention_bwd_delta_f32_kernel": 2}, found)
    attn_ms = sum(found[k][0] for k in (
        "flash_attention_tf32_kernel", "attention_bwd_dq_tf32_kernel",
        "attention_bwd_dkv_tf32_kernel", "attention_bwd_delta_f32_kernel"))
    print(f"{label}: attention {attn_ms:.3f} ms of the profiled step's "
          f"{found['total']:.3f} ms of device time (busy {busy:.1f}%)")
    del model, state, step, opt, data, metrics, batch
    memory_back(torch, dev, base, label)
    check(f"{cfg.name} float32" == GEMMA_F32_NAME, f"{label}: name")
    return {"name": GEMMA_F32_NAME,
            "bwd_launches": GEMMA_F32_KERNELS["flash_attention_bwd"][
                "f32_3xtf32"],
            "bwd_routes": dict(GEMMA_F32_KERNELS["flash_attention_bwd"]),
            "fwd_launches": GEMMA_F32_KERNELS["flash_attention"][
                "f32_3xtf32"],
            "step_walls_s": walls, "model_tflops": model_flops / warm / 1e12,
            "peak_bytes": peak, "attention_ms": attn_ms,
            "device_ms": found["total"], "losses": losses}


def family_attention_timed(torch, dev, gen, card: str) -> dict:
    """Attention at the shapes the new families give it (FAMILY_ATTN), in
    bf16 (and at FAMILY_F16's in f16) through the entry points: the
    forward (its route, held to its plain version) and the backward (with
    the forward's log-sum-exp where the route hands one back, held within
    the dtype's slice limit of HALF_LIMITS), each timed beside its bound,
    its plain version and SDPA's (a yardstick the port never calls).
    Every shape takes the tensor cores both ways; where its head dim is no
    multiple of 64 (Phi-3-vision's 96, h2o-danube's 80) each bf16
    direction is also timed on ``bf16_simt`` (the same values one element
    into their storage), which ``bf16_wgmma`` must beat.  Returns the
    numbers by dtype and shape."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    out = {"bf16": {}, "f16": {}}
    for key, name, (b, hq, hkv, sq, skv, d, causal) in (
            [("bf16", *item) for item in FAMILY_ATTN.items()]
            + [("f16", name, FAMILY_ATTN[name]) for name in FAMILY_F16]):
        dt = torch.bfloat16 if key == "bf16" else torch.float16
        dname = str(dt).removeprefix("torch.")
        wgmma = fa_ops.WGMMA_ROUTES[dt][0]
        q = torch.randn((b, hq, sq, d), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((b, hkv, skv, d), generator=gen,
                            device=dev).to(dt) for _ in range(2))
        kw = dict(causal=causal, window=None, scale=d ** -0.5)
        route = fa_ops.route(dt, d, [t.data_ptr() for t in (q, k, v, q)])
        fa_ops.flash_attention.routes = {}
        got = fa_ops.flash_attention(q, k, v, causal=causal, bkv=skv)
        check(fa_ops.flash_attention.routes == {route: 1},
              f"[attn families] {name}: routes "
              f"{fa_ops.flash_attention.routes}, expected {route}")
        exp32 = fa_ref.attention(q.float(), k.float(), v.float(), **kw)
        stats = half_attention_error(got, exp32, v)
        check(half_within(stats, dname), f"[attn families] {name}: "
              f"outside the {dname} limits {stats}")
        exp = fa_ref.attention(q, k, v, **kw)
        err = (got.double() - exp.double()).abs().max().item()
        tol = ATTN_TOL[dname]
        check(torch.allclose(got.float(), exp.float(), rtol=tol, atol=tol),
              f"[attn families] {name} {dname}: max_abs_err {err:.3e} "
              f"against the plain version (tolerance {tol})")
        # no atomics: a second call gives the same bits
        check(torch.equal(bits(torch, got), bits(torch, fa_ops.flash_attention(
            q, k, v, causal=causal, bkv=skv))), f"[attn families] {name} "
              f"{dname}: two calls differ")
        ms = time_ms(torch, lambda: fa_ops.flash_attention(
            q, k, v, causal=causal, bkv=skv))
        plain = time_ms(torch, lambda: fa_ref.attention(q, k, v, **kw),
                        iters=2, warmup=1)
        sdpa = time_ms(torch, lambda: torch.nn.functional
                       .scaled_dot_product_attention(
                           q, k, v, is_causal=causal, enable_gqa=True))
        pairs = b * (visible_pairs(sq, None) if causal else sq * skv)
        flops = 4 * hq * d * pairs
        nbytes = 2 * (2 * q.numel() + 2 * k.numel())
        bnd, by = bound_ms(nbytes, flops, dname)
        # the backward: the training forward hands it the log-sum-exp
        # where its route gives one
        o, lse = fa_ops._attend(q, k, v, lse=True, **kw)
        dout = torch.randn(o.shape, generator=gen, device=dev).to(dt)
        bwd_route = fa_ops.bwd_route(dt, d, fa_ops._bwd_addresses(
            q, k, v, o, dout, lse))
        check(route == bwd_route == wgmma, f"[attn families] {name}: "
              f"routes {route} / {bwd_route}, expected {wgmma}")
        fa_ops.flash_attention_bwd.routes = {}
        grads = fa_ops.flash_attention_bwd(q, k, v, o, dout, lse=lse, **kw)
        check(fa_ops.flash_attention_bwd.routes == {bwd_route: 1},
              f"[attn families] {name} backward: routes "
              f"{fa_ops.flash_attention_bwd.routes}, expected {bwd_route}")
        exp_g = fa_ref.attention_grad(q.float(), k.float(), v.float(),
                                      dout.float(), **kw)
        nrms = max(slice_nrms(g, e) for g, e in zip(grads, exp_g))
        check(nrms <= HALF_LIMITS[dname][2], f"[attn families] {name} "
              f"{dname} backward ({bwd_route}): rms error per head slice "
              f"{nrms:.3e}")
        del grads, exp_g
        bwd_ms = time_ms(torch, lambda: fa_ops.flash_attention_bwd(
            q, k, v, o, dout, lse=lse, **kw), iters=5, warmup=1)
        bwd_plain = time_ms(torch, lambda: fa_ref.attention_grad(
            q, k, v, dout, **kw), iters=1, warmup=1)
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        o2 = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=causal, enable_gqa=True)
        bwd_sdpa = time_ms(torch, lambda: torch.autograd.grad(
            o2, leaves, dout, retain_graph=True), iters=5, warmup=1)
        bwd_bnd, bwd_by = bound_ms(2 * (4 * q.numel() + 4 * k.numel()),
                                   10 * hq * d * pairs, dname)
        simt = {}
        if key == "f16":
            # the CUDA-core forward on the same values (q one element in),
            # which f16_wgmma must beat
            odd = odd_offset(q)
            fa_ops.flash_attention.routes = {}
            fa_ops.flash_attention(odd, k, v, causal=causal, bkv=skv)
            check(fa_ops.flash_attention.routes == {"f16_simt": 1},
                  f"[attn families] {name}: q at an odd offset took "
                  f"{fa_ops.flash_attention.routes}, expected f16_simt")
            simt = dict(simt_ms=time_ms(torch, lambda: fa_ops.flash_attention(
                odd, k, v, causal=causal, bkv=skv), iters=3, warmup=1))
            del odd
            check(ms < simt["simt_ms"], f"[attn families] {name}: f16_wgmma "
                  f"{ms:.3f} ms is not below f16_simt's "
                  f"{simt['simt_ms']:.3f} ms")
            print(f"[attn families] {name}: f16_simt forward (q at an odd "
                  f"offset) {simt['simt_ms']:.3f} ms; f16_wgmma "
                  f"{simt['simt_ms'] / ms:.1f}x faster")
        if d % 64 and key == "bf16":
            # the CUDA-core loops on the same values: q one element in
            odd = odd_offset(q)
            fa_ops.flash_attention.routes = {}
            fa_ops.flash_attention_bwd.routes = {}
            fa_ops.flash_attention(odd, k, v, causal=causal, bkv=skv)
            fa_ops.flash_attention_bwd(odd, k, v, o, dout, lse=lse, **kw)
            check(fa_ops.flash_attention.routes == {"bf16_simt": 1}
                  and fa_ops.flash_attention_bwd.routes == {"bf16_simt": 1},
                  f"[attn families] {name}: q at an odd offset took "
                  f"{fa_ops.flash_attention.routes} / "
                  f"{fa_ops.flash_attention_bwd.routes}, expected bf16_simt")
            simt = dict(
                simt_ms=time_ms(torch, lambda: fa_ops.flash_attention(
                    odd, k, v, causal=causal, bkv=skv), iters=3, warmup=1),
                bwd_simt_ms=time_ms(torch, lambda: fa_ops.flash_attention_bwd(
                    odd, k, v, o, dout, lse=lse, **kw), iters=2, warmup=1))
            del odd
            check(ms < simt["simt_ms"] and bwd_ms < simt["bwd_simt_ms"],
                  f"[attn families] {name}: bf16_wgmma {ms:.3f} / "
                  f"{bwd_ms:.3f} ms is not below bf16_simt's "
                  f"{simt['simt_ms']:.3f} / {simt['bwd_simt_ms']:.3f} ms")
            print(f"[attn families] {name}: bf16_simt (q at an odd offset) "
                  f"forward {simt['simt_ms']:.3f} ms, backward "
                  f"{simt['bwd_simt_ms']:.3f} ms; bf16_wgmma "
                  f"{simt['simt_ms'] / ms:.1f}x / "
                  f"{simt['bwd_simt_ms'] / bwd_ms:.1f}x faster")
        print(f"[attn families] {name} {key} (q ({b}, {hq}, {sq}, {d}), k, "
              f"v ({b}, {hkv}, {skv}, {d}), "
              f"{'causal' if causal else 'non-causal'}): "
              f"forward [{route}] {ms:.3f} ms ({flops / ms / 1e9:.2f} "
              f"TFLOP/s), plain {plain:.3f} ms, SDPA {sdpa:.3f} ms, bound "
              f"{bnd:.4f} ms ({by}); max_abs_err {err:.3e} against the plain "
              f"version, {key} limits {stats}; backward [{bwd_route}] "
              f"{bwd_ms:.3f} ms, plain {bwd_plain:.3f} ms, SDPA's backward "
              f"{bwd_sdpa:.3f} ms, bound {bwd_bnd:.4f} ms ({bwd_by}), rms "
              f"error per head slice {nrms:.3e} ({card})")
        out[key][name] = dict(
            route=route, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
            library_ms=sdpa, max_abs_err=err, bwd_route=bwd_route,
            bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain, bwd_library_ms=bwd_sdpa,
            bwd_bound_ms=bwd_bnd, **simt)
        del q, k, v, got, exp, exp32, o, lse, dout, leaves, o2
    return {**out, "f32": f32_attention_timed(torch, dev, gen, card)}


def f32_attention_timed(torch, dev, gen, card: str) -> dict:
    """The float32 training forward (``_attend`` asked for the log-sum-exp,
    as ``_Attention`` asks) at FAMILY_F32_ATTN's shapes: on
    ``f32_3xtf32``, held to its plain version (ATTN_TOL) and to float64
    (at most TF32_VS_SIMT times ``f32_simt``'s error on the same values
    one element into their storage, per slice of 8 heads), its
    log-sum-exp to ``ref.attention_lse``'s, and timed beside
    ``f32_simt``, which it must beat, its 3xTF32 bound, the plain version
    and SDPA's forward.  Returns the numbers by shape."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    out = {}
    tol = ATTN_TOL["float32"]
    for name, (b, hq, hkv, s, d, window) in FAMILY_F32_ATTN.items():
        q = torch.randn((b, hq, s, d), generator=gen, device=dev)
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev)
                for _ in range(2))
        kw = dict(causal=True, window=window, scale=d ** -0.5)
        fa_ops.flash_attention.routes = {}
        got, lse = fa_ops._attend(q, k, v, lse=True, **kw)
        odd = odd_offset(q)
        simt, _ = fa_ops._attend(odd, k, v, lse=False, **kw)
        check(fa_ops.flash_attention.routes
              == {"f32_3xtf32": 1, "f32_simt": 1} and lse is not None,
              f"[attn families] {name}: routes "
              f"{fa_ops.flash_attention.routes}, expected f32_3xtf32 with a "
              f"log-sum-exp and, one element in, f32_simt")
        exp, exp_lse = fa_ref.attention_lse(q, k, v, **kw)
        diff = (got.double() - exp.double()).abs()
        err = diff.max().item()
        check(bool((diff <= tol + tol * exp.double().abs()).all()),
              f"[attn families] {name} float32: beyond rtol and atol {tol} "
              f"of the plain version ({err:.3e})")
        lse_err = (lse - exp_lse).abs().max().item()
        check(lse_err <= tol, f"[attn families] {name}: log-sum-exp "
              f"{lse_err:.3e} off ref.attention_lse's")
        exact = attention64(torch, fa_ref, q, k, v, True, window)
        ratio = tf32_vs_simt(got, simt, exact)
        check(ratio <= TF32_VS_SIMT, f"[attn families] {name}: f32_3xtf32 "
              f"{ratio:.2f} x f32_simt's float64 error (limit "
              f"{TF32_VS_SIMT})")
        del exact, exp, exp_lse, simt
        ms = time_ms(torch, lambda: fa_ops._attend(q, k, v, lse=True, **kw))
        simt_ms = time_ms(torch, lambda: fa_ops._attend(odd, k, v, lse=False,
                                                        **kw),
                          iters=5, warmup=1)
        plain = time_ms(torch, lambda: fa_ref.attention(q, k, v, **kw),
                        iters=2, warmup=1)
        # a window of S keys or more hides none: SDPA's causal mask
        check(window >= s, f"[attn families] {name}: window {window}")
        sdpa = time_ms(torch, lambda: torch.nn.functional
                       .scaled_dot_product_attention(
                           q, k, v, is_causal=True, enable_gqa=True))
        flops = 4 * b * hq * d * visible_pairs(s, window)
        nbytes = 4 * (2 * q.numel() + 2 * k.numel())
        bnd, by = bound_ms(nbytes, TF32_PRODUCTS * flops, "tf32")
        check(ms < simt_ms, f"[attn families] {name}: f32_3xtf32 {ms:.3f} "
              f"ms is not below f32_simt's {simt_ms:.3f}")
        print(f"[attn families] {name} float32 (q ({b}, {hq}, {s}, {d}), k, "
              f"v ({b}, {hkv}, {s}, {d}), causal, window {window}): the "
              f"training forward [f32_3xtf32, with its log-sum-exp] {ms:.3f} "
              f"ms ({flops / ms / 1e9:.2f} TFLOP/s; its 3xTF32 bound "
              f"{bnd:.4f} ms ({by}) is {100 * bnd / ms:.1f}% of it), "
              f"f32_simt (q one element in) {simt_ms:.3f} ms "
              f"({simt_ms / ms:.1f}x), plain {plain:.3f} ms, SDPA {sdpa:.3f} "
              f"ms; max_abs_err {err:.3e} against the plain version, "
              f"log-sum-exp {lse_err:.3e}; against float64 {ratio:.2f} x "
              f"f32_simt's error (limit {TF32_VS_SIMT}) ({card})")
        out[name] = dict(route="f32_3xtf32", ms=ms, simt_ms=simt_ms,
                         plain_ms=plain, bound_ms=bnd, bound_by=by,
                         library_ms=sdpa, max_abs_err=err, vs_simt=ratio)
        del q, k, v, got, lse, odd
    return out


# -- Slice 4: the process pool, fault tolerance, training that checkpoints --
# the three-pass checkpoint-barrier runs of [faults]: a 4 x 4 grid of IB
# tiles, on which the barriers still save ops (serial: 68 ops recomputed
# without them, 64 and 4 C tiles from disk with them; 560 / 544 / 16 at
# the 8 x 8 grid)
FAULTS_PASSES_N = 4 * IB

PROCS_ITERS = 3          # Listing 1 iterations in one workflow: cold,
                         # re-shipped (A/B replicas settled), warm (delta)
SHM_NEEDED = 16 << 30    # /dev/shm the [procs] phase needs at n = 8192:
                         # every ref's head stays live (the reference's
                         # pinning), Listing 1's 512 partial products an
                         # iteration among them (11.4 GiB over the three)


def worker_probe(c_tile):
    """Op body of ``[procs]``: the facts of the process it runs in, with
    its GEMM launch counters and staged bytes read *and reset* (a
    ``procs`` worker counts in its own process).  Recorded after a
    Listing 1 iteration on a C tile its rank owns, so it runs after every
    leaf product of the iteration."""
    import os as _os

    import torch

    from repro_torch.core import shm_store
    from repro_torch.core.backends import procs
    from repro_torch.kernels.gemm import ops

    facts = {"pid": _os.getpid(), "rank": procs._CURRENT_RANK,
             "cuda": torch.cuda.is_available(),
             "context": torch.cuda.is_initialized(),
             "device": str(c_tile.device),
             "launches": ops.matmul.launches,
             "routes": dict(ops.matmul.routes),
             "other": (ops.matmul_accumulate.launches
                       + ops.accumulate_body.calls),
             "staged": dict(shm_store.STAGED),
             "foreign": sorted(k for k in sys.modules
                               if k in ("jax", "jaxlib", "repro")
                               or k.startswith(("jax.", "jaxlib.",
                                                "repro.")))}
    ops.matmul.launches = 0
    ops.matmul.routes = {}
    shm_store.STAGED.update(to_host=0, to_device=0, seconds=0.0)
    return facts


class ShmWatch:
    """Samples the bytes this process's procs sessions hold in /dev/shm
    every 10 ms while it is entered; ``peak`` is the largest sample."""

    def __init__(self):
        from repro_torch.core.shm_store import SEGMENT_PREFIX

        self.prefix = f"{SEGMENT_PREFIX}{os.getpid():x}-"
        self.peak = 0
        self._stop = threading.Event()

    def held(self) -> tuple[int, int]:
        """``(files, bytes)`` of the sessions' segments now."""
        files = size = 0
        for name in os.listdir("/dev/shm"):
            if name.startswith(self.prefix):
                try:
                    size += os.path.getsize(os.path.join("/dev/shm", name))
                    files += 1
                except OSError:
                    pass
        return files, size

    def _run(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self.held()[1])

    def __enter__(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def shm_gone(label: str) -> None:
    """After ``shutdown_pools``: no segment of this process's sessions is
    left in /dev/shm (the workers unlink theirs as they exit)."""
    watch = ShmWatch()
    deadline = time.monotonic() + 30
    while True:
        files, size = watch.held()
        if not files or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    check(files == 0, f"{label}: {files} segments ({size} bytes) of the "
          f"sessions left in /dev/shm after shutdown")
    print(f"{label}: no segment of the sessions left in /dev/shm")


def listing1_iterations(torch, bind, A, B, backend, iters: int):
    """Listing 1 ``iters`` times in ONE workflow on one executor, into
    fresh C tiles each time (A and B the same tiles), with
    :func:`worker_probe` recorded on each rank's first C tile after each
    iteration.  Returns per iteration ``(C, wall, probe facts, control
    messages)``, the stats and the executor."""
    from repro_torch.linalg import Tiled
    from repro_torch.linalg.distributed import (distributed_gemm_listing1,
                                                make_distributed_inputs,
                                                owner_rank)

    nt = N_LISTING // IB
    ex = bind.LocalExecutor(4, backend=backend)
    runs = []
    with bind.Workflow(n_nodes=4, executor=ex) as wf:
        a, b, c = make_distributed_inputs(wf, A, B, ib=IB, NP=2, NQ=2)
        for it in range(iters):
            if it:
                c = Tiled.zeros(wf, nt, nt, IB, torch.float32, "C",
                                rank_of=lambda i, k: owner_rank(i, k, 2, 2),
                                device=A.device)
            distributed_gemm_listing1(wf, a, b, c, 2, 2)
            probes = []
            for r in range(4):
                with bind.node(r):
                    probes.append(wf.apply(worker_probe,
                                           (c.tile(r // 2, r % 2),),
                                           name="probe"))
            before = ex._stats.control_messages
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            C = c.to_array()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            facts = [wf.fetch(p) for p in probes]
            runs.append((C, wall, facts,
                         ex.stats.control_messages - before))
    return runs, ex.stats, ex


def procs_phase(torch, dev, bind, A, B, card, same_bits, zero_counts,
                serial_busy) -> dict:
    """``[procs]``: Listing 1 at n = N_LISTING, ib = IB, float32, 2 x 2
    ranks on ``backend="procs"``: one spawned worker process per rank,
    each with its own CUDA context on the card, every leaf product the
    hand-written GEMM (``f32_3xtf32``) inside a worker.  PROCS_ITERS
    iterations in one workflow (cold; re-shipped once A's and B's replicas
    settle; warm, one "run" message a worker) against the same program on
    ``serial``: C of each iteration bit for bit, the transfer stream and
    the stats equal, 512 launches an iteration summed over four distinct
    worker processes on the card that hold no jax and no repro, no serial
    fallback; walls, the busy share, staged bytes and /dev/shm bytes
    printed; after shutdown no segment left and the device memory back."""
    from repro_torch.core import shm_store
    from repro_torch.core.backends.procs import shutdown_pools

    free = shutil.disk_usage("/dev/shm").free
    check(free >= SHM_NEEDED, f"[procs] /dev/shm has {free} bytes free, "
          f"fewer than the {SHM_NEEDED} bytes Listing 1's segments need at "
          f"n = {N_LISTING}")
    base = memory_base(torch, dev)
    nt = N_LISTING // IB
    want = nt ** 3
    zero_counts()
    serial, s_stats, s_ex = listing1_iterations(torch, bind, A, B,
                                                "serial", PROCS_ITERS)
    backend = bind.ProcessPoolBackend()
    parent = dict(shm_store.STAGED)
    with ShmWatch() as watch:
        runs, stats, ex = listing1_iterations(torch, bind, A, B, backend,
                                              PROCS_ITERS)
        held_files, held_bytes = watch.held()
    staged_parent = {k: shm_store.STAGED[k] - parent.get(k, 0)
                     for k in ("to_host", "to_device")}
    names = ("cold", "re-shipped", "warm")
    pids = set()
    for it, ((C, wall, facts, msgs), (Cs, swall, sfacts, smsgs)) in \
            enumerate(zip(runs, serial)):
        label = f"[procs] iteration {it + 1} ({names[it]})"
        same_bits(f"{label}: C vs serial", C, Cs)
        launches = sum(f["launches"] for f in facts)
        routes = {}
        for f in facts:
            for r, n in f["routes"].items():
                routes[r] = routes.get(r, 0) + n
        check(launches == want and routes == {F32_ROUTE: want},
              f"{label}: {launches} GEMM launches {routes} in the workers, "
              f"expected {want} on {F32_ROUTE}")
        check(sum(f["launches"] for f in sfacts) == want,
              f"{label}: serial made {sum(f['launches'] for f in sfacts)} "
              f"launches")
        check(not any(f["other"] for f in facts),
              f"{label}: other GEMM paths ran {[f['other'] for f in facts]}")
        check([f["rank"] for f in facts] == [0, 1, 2, 3]
              and len({f["pid"] for f in facts} | {os.getpid()}) == 5,
              f"{label}: not four distinct worker processes: {facts}")
        check(all(f["cuda"] and f["context"] and f["device"] == "cuda:0"
                  for f in facts),
              f"{label}: a worker without its CUDA context on the card")
        check(not any(f["foreign"] for f in facts),
              f"{label}: a worker loaded {[f['foreign'] for f in facts]}")
        pids.update(f["pid"] for f in facts)
        to_dev = sum(f["staged"]["to_device"] for f in facts)
        to_host = sum(f["staged"]["to_host"] for f in facts)
        secs = max(f["staged"]["seconds"] for f in facts)
        print(f"{label}: wall {wall:.4f} s ({2 * N_LISTING ** 3 / wall / 1e12:.3f} "
              f"TFLOP/s) against serial's {swall:.4f} s ({wall / swall:.1f}x); "
              f"{launches} {F32_ROUTE} launches over worker pids "
              f"{sorted(f['pid'] for f in facts)}; control messages {msgs}; "
              f"staged in the workers {to_dev / 2 ** 30:.3f} GiB "
              f"host->device, {to_host / 2 ** 30:.3f} GiB device->host, "
              f"the busiest worker {secs:.3f} s in those copies "
              f"({100 * secs / wall:.1f}% of the wall); busy share "
              f"{serial_busy * swall / wall:.1f}% (the serial run's profiled "
              f"device time over this wall) ({card})")
    check(pids == {f["pid"] for f in runs[0][2]},
          f"[procs] the workers changed between iterations: {pids}")
    check(runs[-1][3] == 4, f"[procs] the warm iteration sent "
          f"{runs[-1][3]} control messages, expected one 'run' a worker")
    check(backend.fallbacks == 0 and backend.plans_run == PROCS_ITERS,
          f"[procs] fallbacks {backend.fallbacks}, plans run "
          f"{backend.plans_run}")
    check(list(stats.transfers) == list(s_stats.transfers),
          "[procs] transfer stream differs from serial's")
    for name in ("ops_executed", "copies_elided", "wavefronts",
                 "wavefront_flops", "bytes_transferred", "message_count"):
        check(getattr(stats, name) == getattr(s_stats, name),
              f"[procs] {name} {getattr(stats, name)} != serial's "
              f"{getattr(s_stats, name)}")
    check(stats.peak_live_bytes >= s_stats.peak_live_bytes,
          "[procs] peak live bytes below serial's")
    print(f"[procs] stats equal serial's: ops {stats.ops_executed}, "
          f"messages {stats.message_count}, bytes "
          f"{stats.bytes_transferred}, wavefronts {len(stats.wavefronts)}; "
          f"control messages {stats.control_messages} in all; the parent "
          f"staged {staged_parent['to_host'] / 2 ** 30:.3f} GiB "
          f"device->host (seeds), {staged_parent['to_device'] / 2 ** 30:.3f}"
          f" GiB host->device (fetches); /dev/shm: peak "
          f"{watch.peak / 2 ** 30:.3f} GiB sampled, {held_files} segments "
          f"({held_bytes / 2 ** 30:.3f} GiB) held at the end, "
          f"{free / 2 ** 30:.1f} GiB free before")
    out = {"launches": want, "walls": [r[1] for r in runs],
           "serial_walls": [r[1] for r in serial], "C": serial[0][0]}
    del runs, serial, ex, s_ex, C, Cs
    shutdown_pools()
    shm_gone("[procs]")
    keep = out["C"].untyped_storage().nbytes()
    memory_back(torch, dev, base + keep, "[procs] the phase")
    return out


def faults_phase(torch, dev, bind, A, B, C_ref, card, same_bits) -> dict:
    """``[faults]``: Listing 1 under ``FaultInjector.kill_rank``: simulated
    on ``serial``, ``fused`` and ``threads``; on ``procs`` a real worker
    ``SIGKILL``, permanent (elastic rebind onto ``choose_replacement``'s
    pick on a ring); C bit for bit the fault-free C, one recovery, fewer
    ops recomputed than a full replay.  Then three passes of Listing 1 at
    n = FAULTS_PASSES_N into one C with rank 1 killed at the last
    boundary, with and without ``Workflow.checkpoint`` barriers over C
    after the first pass (on ``serial``, and with them on ``procs``: a
    transient ``SIGKILL``, the worker respawned): the barriers' versions
    come back from disk and fewer ops are recomputed."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core.backends import procs as procs_mod
    from repro_torch.core.recovery import choose_replacement
    from repro_torch.launch.mesh import make_topology
    from repro_torch.linalg.distributed import (distributed_gemm_listing1,
                                                make_distributed_inputs,
                                                owner_rank)

    base = memory_base(torch, dev)

    def run(backend, injector=None, topology=None, passes=1, ckpt=None,
            operands=(A, B)):
        ex = bind.LocalExecutor(4, backend=backend, fault_injector=injector,
                                topology=topology)
        nt = operands[0].shape[0] // IB
        with bind.Workflow(n_nodes=4, executor=ex) as wf:
            a, b, c = make_distributed_inputs(wf, *operands, ib=IB, NP=2,
                                              NQ=2)
            distributed_gemm_listing1(wf, a, b, c, 2, 2)
            if ckpt is not None:
                # one barrier on each rank over the C tiles it owns, each
                # into a directory of its own (the ranks' workers save at
                # once): no replica is shipped for it, so a killed rank's
                # tiles are lost and come back from disk
                for r in range(4):
                    with bind.node(r):
                        wf.checkpoint(
                            [c.tile(i, k) for i in range(nt)
                             for k in range(nt)
                             if owner_rank(i, k, 2, 2) == r],
                            CheckpointManager(f"{ckpt}/rank{r}",
                                              async_save=False))
            for _ in range(passes - 1):
                distributed_gemm_listing1(wf, a, b, c, 2, 2)
            t0 = time.perf_counter()
            C = c.to_array()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return C, ex.stats, ex, wall

    _, free_stats, _, _ = run("serial")
    full = free_stats.ops_executed
    ring = make_topology("ring", 4)
    cases = [("serial", "serial", dict(injector=1)),
             ("fused", "fused", dict(injector=1)),
             ("threads", "threads", dict(injector=1)),
             ("procs permanent SIGKILL", "procs",
              dict(injector=2, topology=ring))]
    out = {}
    for label, backend, kw in cases:
        victim = kw.pop("injector")
        inj = bind.FaultInjector.kill_rank(victim, 2,
                                           permanent=backend == "procs")
        backend_obj = (bind.ProcessPoolBackend() if backend == "procs"
                       else backend)
        C, st, ex, wall = run(backend_obj, inj, **kw)
        tag = f"[faults] {label}"
        same_bits(f"{tag}: C vs the fault-free C", C, C_ref)
        check(st.recoveries >= 1 and inj.fired,
              f"{tag}: {st.recoveries} recoveries")
        check(0 < st.recomputed_ops < full,
              f"{tag}: {st.recomputed_ops} ops recomputed of {full}")
        extra = ""
        if backend == "procs":
            check(backend_obj.fallbacks == 0, f"{tag}: fell back to serial")
            pool = procs_mod._POOLS[4]
            repl = choose_replacement(victim, [0, 1, 3], ring)
            check(ex._rank_map == {victim: repl}
                  and not ex._stores[victim] and not pool.alive[victim],
                  f"{tag}: rank map {ex._rank_map}, stores of the dead "
                  f"rank {len(ex._stores[victim])}")
            extra = (f", rank {victim} decommissioned, its placements "
                     f"re-bound onto rank {repl} (ring topology)")
        print(f"{tag}: rank {victim} killed at wavefront 2: "
              f"{st.recoveries} recovery, {st.recomputed_ops} of {full} "
              f"ops recomputed (ratio {st.recompute_ratio:.3f}), recovery "
              f"{st.recovery_time_s:.3f} s, wall {wall:.3f} s; C bit for "
              f"bit the fault-free C{extra} ({card})")
        out[label] = {"recomputed": st.recomputed_ops, "wall": wall}
        del C, ex
    # the checkpoint barrier: three passes (a pass's products do not wait
    # for the one before, so the barrier after pass 1 runs beside pass 2's
    # last add, and pass 3's last add reads what pass 2 left: with two
    # passes the barrier saves no op), rank 1 lost at the last boundary.
    # On the top-left FAULTS_PASSES_N block of A and B: a 4 x 4 grid of
    # the same tiles makes the same recovery (the lost tiles' last adds
    # recomputed fewer with the barriers, their C tiles read from disk)
    # for an eighth of the leaves and of procs' host staging
    ckpt_root = ROOT / "build" / "chip_smoke_faults_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    m = FAULTS_PASSES_N
    operands = (A[:m, :m].contiguous(), B[:m, :m].contiguous())
    C3_ref, plain_stats, _, _ = run("serial", passes=3, operands=operands)
    full3 = plain_stats.ops_executed
    _, barrier_stats, _, _ = run("serial", passes=3, operands=operands,
                                 ckpt=str(ckpt_root / "fault-free"))
    # the same kill with and without the barriers simulated on serial
    # (the op counts are the backends' common accounting, equal above),
    # then with them on procs: a real, transient SIGKILL (the worker is
    # respawned), the dead worker's C tiles read back from the files its
    # barrier wrote
    got = {}
    for label, backend, with_barrier, stats_ in (
            ("serial, no barrier", "serial", False, plain_stats),
            ("serial, barriers", "serial", True, barrier_stats),
            ("procs, barriers", "procs", True, barrier_stats)):
        backend_obj = (bind.ProcessPoolBackend() if backend == "procs"
                       else backend)
        inj = bind.FaultInjector.kill_rank(1, len(stats_.wavefronts) - 1)
        t0 = time.perf_counter()
        C, st, ex, _ = run(backend_obj, inj, passes=3, operands=operands,
                           ckpt=str(ckpt_root / label) if with_barrier
                           else None)
        wall = time.perf_counter() - t0
        tag = (f"[faults] three passes at n={m} ({label} after the first "
               f"pass)")
        same_bits(f"{tag}: C vs the fault-free C", C, C3_ref)
        check(st.recoveries == 1 and 0 < st.recomputed_ops < full3,
              f"{tag}: {st.recoveries} recoveries, {st.recomputed_ops} ops "
              f"recomputed of {full3}")
        extra = ""
        if backend == "procs":
            check(backend_obj.fallbacks == 0, f"{tag}: fell back to serial")
            # the killed worker's replacement is the pool's youngest
            pool = procs_mod._POOLS[4]
            others = [pool.spawned_at[r] for r in range(4) if r != 1]
            check(pool.alive[1] and pool.procs[1].is_alive()
                  and pool.spawned_at[1] > max(others),
                  f"{tag}: the killed worker was not replaced")
            extra = (f"; worker 1 killed and respawned "
                     f"{pool.spawned_at[1] - max(others):.1f} s after the "
                     f"others, as pid {pool.procs[1].pid}")
        got[label] = st
        print(f"{tag}: rank 1 killed at the last boundary: "
              f"{st.recomputed_ops} of {full3} ops recomputed, "
              f"{st.restored_versions} versions restored from disk, "
              f"recovery {st.recovery_time_s:.3f} s, wall {wall:.3f} s; C "
              f"bit for bit the fault-free C{extra} ({card})")
        del C, ex
    plain, barred = got["serial, no barrier"], got["procs, barriers"]
    check(barred.restored_versions >= 1
          and barred.recomputed_ops < plain.recomputed_ops
          and (barred.recomputed_ops, barred.restored_versions)
          == (got["serial, barriers"].recomputed_ops,
              got["serial, barriers"].restored_versions),
          f"[faults] the barriers recomputed {barred.recomputed_ops} ops "
          f"({got['serial, barriers'].recomputed_ops} simulated), without "
          f"them {plain.recomputed_ops}")
    print(f"[faults] with the barriers {barred.recomputed_ops} ops "
          f"recomputed ({barred.restored_versions} C tiles from disk), "
          f"without them {plain.recomputed_ops}")
    got = {True: barred, False: plain}
    out["barrier"] = {"with": got[True].recomputed_ops,
                      "without": got[False].recomputed_ops}
    shutil.rmtree(ckpt_root, ignore_errors=True)
    del C3_ref, operands
    procs_mod.shutdown_pools()
    shm_gone("[faults]")
    memory_back(torch, dev, base, "[faults] the phase")
    return out


TRAIN_CKPT_ARCH = "granite_moe_3b_a800m"
TRAIN_CKPT_LAYERS, TRAIN_CKPT_SEQ, TRAIN_CKPT_STEPS = 2, 2048, 4
SUPERVISED = ["--arch", "gemma_7b", "--reduced", "--steps", "30", "--batch",
              "4", "--seq", "32", "--lr", "1e-3", "--ckpt-every", "10"]


def train_ckpt_phase(torch, dev, card: str, zero_counts, counts) -> dict:
    """``[train_ckpt]``: (1) in process, TRAIN_CKPT_ARCH at its published
    widths with TRAIN_CKPT_LAYERS layers, bf16, B 1 x S TRAIN_CKPT_SEQ,
    TRAIN_CKPT_STEPS AdamW steps, saving parameters and optimizer state
    through ``CheckpointManager`` after step 1; a fresh model and optimizer
    from another seed restore it and take steps 2-4: their losses equal
    the uninterrupted run's, the attention forward and backward launched
    by route as ``[train_families]`` counts them; (2) the trainer under the
    ``Supervisor``: a run that crashes at step 25 (exit 42) and a second
    supervisor that resumes it from the step-19 checkpoint to the final
    loss of an uninterrupted run (relative 1e-5)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import LanguageModel
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.runtime import Supervisor
    from repro_torch.train import make_train_step

    root = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    disk = shutil.disk_usage(root).free
    cfg = dataclasses.replace(configs.get(TRAIN_CKPT_ARCH),
                              n_layers=TRAIN_CKPT_LAYERS)
    data = SyntheticLMDataset(cfg.vocab_size, TRAIN_CKPT_SEQ, 1, seed=SEED,
                              device=dev)
    opt = AdamW(learning_rate=warmup_cosine(1e-3, 1, TRAIN_CKPT_STEPS))

    def trainer(seed):
        model = LanguageModel(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(seed))
        return model, opt.init(model), make_train_step(model, opt)

    label = f"[train_ckpt] {cfg.name}"
    model, state, step = trainer(SEED)
    params = dict(model.named_parameters())
    mgr = CheckpointManager(str(root / "inproc"), keep_n=1)
    losses, saved = [], {}
    zero_counts()
    for i in range(TRAIN_CKPT_STEPS):
        state, metrics = step(state, data.batch_at(i))
        losses.append(float(metrics["loss"]))
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(i, (params, state), extra={"step": i})
            saved["snapshot_s"] = time.perf_counter() - t0
            mgr.wait()
            saved["write_s"] = time.perf_counter() - t0
    routes = {"flash_attention": dict(fa_ops.flash_attention.routes),
              "flash_attention_bwd": dict(fa_ops.flash_attention_bwd.routes)}
    want = {"flash_attention": {"bf16_wgmma": 2 * TRAIN_CKPT_LAYERS
                                * TRAIN_CKPT_STEPS},
            "flash_attention_bwd": {"bf16_wgmma": TRAIN_CKPT_LAYERS
                                    * TRAIN_CKPT_STEPS}}
    check(routes == want, f"{label}: launches by route {routes}, expected "
          f"{want}")
    others = {k: v for k, v in counts().items()
              if v and k not in ("flash_attention", "flash_attention_bwd")}
    check(not others, f"{label}: unexpected launches {others}")
    step_dir = Path(mgr._step_dir(1))
    nbytes = sum(f.stat().st_size for f in step_dir.iterdir())
    n_params = sum(p.numel() for p in params.values())
    del model, state, step, params, metrics
    # the baseline once the uninterrupted run has taken every workspace
    # its kernels and cuBLAS keep: the restored run must give back all of
    # its own memory
    base = memory_base(torch, dev)
    model, state, step = trainer(SEED + 1)
    params = dict(model.named_parameters())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (restored, state), extra = mgr.restore((params, state))
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(restored[name])
    del restored, p     # the loop's last parameter (an expert's 60 MiB)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(extra == {"step": 1}, f"{label}: extra {extra}")
    resumed = []
    zero_counts()
    for i in range(2, TRAIN_CKPT_STEPS):
        state, metrics = step(state, data.batch_at(i))
        resumed.append(float(metrics["loss"]))
    bitwise = resumed == losses[2:]
    check(all(math.isclose(a, b, rel_tol=1e-5)
              for a, b in zip(resumed, losses[2:])),
          f"{label}: resumed losses {resumed} against {losses[2:]}")
    r_routes = {"flash_attention": dict(fa_ops.flash_attention.routes),
                "flash_attention_bwd": dict(fa_ops.flash_attention_bwd.routes)}
    print(f"{label}: {cfg.n_layers} layers at the published widths, "
          f"{n_params:,} parameters, bf16, B 1 x S {TRAIN_CKPT_SEQ}: losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}; launches by route over "
          f"{TRAIN_CKPT_STEPS} steps {routes}; checkpoint after step 1: "
          f"{nbytes:,} bytes in {len(list(step_dir.iterdir()))} files, "
          f"save returned after {saved['snapshot_s']:.3f} s (host snapshot), "
          f"written after {saved['write_s']:.3f} s, restored in "
          f"{restore_s:.3f} s ({disk / 2 ** 30:.1f} GiB free on disk "
          f"before); a fresh model from seed {SEED + 1} restored it and took "
          f"steps 3-{TRAIN_CKPT_STEPS}: losses "
          f"{', '.join(f'{x:.6f}' for x in resumed)}, bit for bit "
          f"{bitwise}, launches by route {r_routes} ({card})")
    out = {"bytes": nbytes, "snapshot_s": saved["snapshot_s"],
           "write_s": saved["write_s"], "restore_s": restore_s,
           "bitwise": bitwise}
    del model, state, step, params, metrics, mgr
    memory_back(torch, dev, base, label)

    # the trainer under the Supervisor, on the card
    env = dict(os.environ, PYTHONPATH=str(SRC))
    ck, hb = root / "ck", root / "hb"
    hb.touch()
    log = root / "log.jsonl"
    argv = [sys.executable, "-m", "repro_torch.launch.train", *SUPERVISED,
            "--ckpt-dir", str(ck), "--heartbeat", str(hb), "--log-file",
            str(log)]
    t0 = time.perf_counter()
    sup = Supervisor([*argv, "--crash-at-step", "25"], heartbeat_file=str(hb),
                     heartbeat_timeout=600, max_restarts=0, env=env)
    try:
        sup.run(poll=0.2)
        fail("[train_ckpt] the crashing run exited cleanly")
    except RuntimeError as e:
        check("last exit 42" in str(e), f"[train_ckpt] supervisor: {e}")
    crash_s = time.perf_counter() - t0
    metrics_out = root / "resumed.json"
    t0 = time.perf_counter()
    sup2 = Supervisor([*argv, "--metrics-out", str(metrics_out)],
                      heartbeat_file=str(hb), heartbeat_timeout=600,
                      max_restarts=2, env=env)
    check(sup2.run(poll=0.2) == 0 and sup2.restarts == 0,
          "[train_ckpt] the resumed run did not exit 0")
    resume_s = time.perf_counter() - t0
    logged = [json.loads(line)["step"]
              for line in log.read_text().splitlines()]
    check(logged == [0, 10, 20, 20, 29], f"[train_ckpt] logged steps "
          f"{logged}: the resumed run did not go on from step 20")
    steps = sorted(n.name for n in ck.iterdir())
    check(steps == ["step_0000000009", "step_0000000019", "step_0000000029"],
          f"[train_ckpt] checkpoints {steps}")
    with open(metrics_out) as f:
        resumed_loss = json.load(f)["final"]["loss"]
    ref_out = root / "ref.json"
    t0 = time.perf_counter()
    check(launch_train.main([*SUPERVISED, "--metrics-out", str(ref_out)])
          == 0, "[train_ckpt] the uninterrupted run failed")
    ref_s = time.perf_counter() - t0
    with open(ref_out) as f:
        ref_loss = json.load(f)["final"]["loss"]
    check(math.isclose(resumed_loss, ref_loss, rel_tol=1e-5),
          f"[train_ckpt] resumed final loss {resumed_loss} against "
          f"{ref_loss}")
    print(f"[train_ckpt] supervisor, gemma_7b reduced on the card: the "
          f"run with --crash-at-step 25 exited 42 after {crash_s:.1f} s "
          f"(supervisor gave up, 0 restarts); the second supervisor resumed "
          f"it from step 19 (logged steps {logged}) and exited 0 after "
          f"{resume_s:.1f} s; final loss {resumed_loss!r} against the "
          f"uninterrupted run's {ref_loss!r} ({ref_s:.1f} s in process), "
          f"bit for bit {resumed_loss == ref_loss}")
    out["supervised"] = {"resumed": resumed_loss, "ref": ref_loss}
    shutil.rmtree(root, ignore_errors=True)
    return out


# -- Slice 3b: the LM on rank meshes — explicit DP, expert parallelism -------
DP_ARCH = "h2o_danube_1_8b"
DP_LAYERS, DP_BATCH, DP_SEQ, DP_STEPS, DP_LR = 2, 8, 1024, 3, 1e-3
# name, mesh shape, axis names, schedule, compress_outer
DP_RUNS = (("tree", (4,), ("data",), "tree", False),
           ("ring", (4,), ("data",), "ring", False),
           ("hierarchical", (2, 2), ("pod", "data"), "hierarchical", False),
           ("hierarchical+int8", (2, 2), ("pod", "data"), "hierarchical",
            True))
# f32 at d 80 takes the tensor cores in 3xTF32 both ways (80 is one of
# ops.TF32_HEAD_DIMS, and the training forward saves its log-sum-exp):
# each of the 4 ranks runs 2 layers' forward and backward a step
DP_ROUTE = "f32_3xtf32"
DP_KERNELS = {"flash_attention": {DP_ROUTE: 8},
              "flash_attention_bwd": {DP_ROUTE: 8}}
# the int8 run's share of parameters that may leave the reference
# self-test's elementwise bound (5e-2 relative + 5e-3) of the single stream;
# none may move further from it than 2 DP_STEPS lr + 5e-3 (each step's AdamW
# update of each run is about lr whatever its gradient's size: at most every
# step of the one against the other's)
DP_INT8_BEYOND = 1e-6
# Slice 3c: the policy's step with parameters, masters and moments at rest
# as per-rank shards (flat FSDP) on (2, 2) ranks sharing the card.  The
# activations stay whole, so each layer's attention runs once on the whole
# batch, again in the remat recompute, and its backward once
FSDP_MESH = (2, 2)
FSDP_KERNELS = {"flash_attention": {DP_ROUTE: 2 * DP_LAYERS},
                "flash_attention_bwd": {DP_ROUTE: DP_LAYERS}}
FSDP_FULL_STEPS = 3          # h2o-danube-1.8b at its published 24 layers
EP_ARCH, EP_LAYERS, EP_RANKS = "moonshot_v1_16b_a3b", 4, 4
EP_BATCH, EP_PROMPT, EP_DECODE = 2, 4096, 8
EP_KERNELS = {"bf16_wgmma": EP_LAYERS}
EP_GRAD_LAYERS, EP_GRAD_SEQ = 2, 2048
TP_DECODE = 8                # decode steps with the weights TP at rest


def _params_beyond(torch, model, want: dict, rtol: float, atol: float):
    """``(largest |p - want| - rtol |want|, elements where that exceeds
    atol, largest |p - want|)`` over ``model``'s parameters."""
    worst, beyond, moved = 0.0, 0, 0.0
    with torch.no_grad():
        for n, p in model.named_parameters():
            diff = (p - want[n]).abs()
            moved = max(moved, float(diff.max()))
            diff -= rtol * want[n].abs()
            worst = max(worst, float(diff.max()))
            beyond += int((diff > atol).sum())
    return worst, beyond, moved


def _flipped_moments(torch, model, m: dict, want: dict, want_m: dict,
                     rtol: float, atol: float) -> int:
    """The witness of an element that left the bound: how many of those
    elements have a first moment (rank 0's of ``m``) of the other sign
    than the single stream's (``want_m``)."""
    flipped = 0
    with torch.no_grad():
        for n, p in model.named_parameters():
            out_of = (p - want[n]).abs() - rtol * want[n].abs() > atol
            if bool(out_of.any()):
                flipped += int((torch.sign(m[n].shards[0][out_of])
                                != torch.sign(want_m[n][out_of])).sum())
    return flipped


def _clone_tree(torch, tree):
    """A decode-state tree with every tensor copied (decode writes its
    caches in place)."""
    if isinstance(tree, dict):
        return {k: _clone_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(torch, v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _largest_share(torch, got: dict, want: dict) -> float:
    """The largest ``|got - want|`` over a leaf, as a share of the leaf's
    largest ``|want|``, over every leaf."""
    worst = 0.0
    for n, g in got.items():
        w = want[n].float()
        worst = max(worst, float((g.float() - w).abs().max())
                    / max(float(w.abs().max()), 1e-30))
    return worst


def lm_mesh_phase(torch, dev, card: str, zero_counts, counts) -> dict:
    """``[lm_mesh]``: the LM on rank meshes that share the card.

    (a) explicit data parallelism: h2o-danube-1.8b at its published widths,
    DP_LAYERS layers, float32, DP_BATCH x DP_SEQ tokens, DP_STEPS AdamW
    steps through ``make_manual_dp_train_step`` for each of DP_RUNS, held
    to ``make_train_step`` on the same card with the reference self-test's
    bounds; every rank's replica, masters and moments bit for bit rank 0's
    after every step; every step's copies and bytes the schedule's
    closed-form count; the attention launches by route every step, no
    plain version, and every attention call of the first run's first step
    (forward and backward, at the rank's shape) held to its plain version
    on the same inputs; warm step wall, busy share, copies and GiB a step.
    (b) expert parallelism: Moonshot at its published widths, EP_LAYERS
    layers, bf16, a prefill of EP_BATCH x EP_PROMPT tokens under
    ``make_policy(make_host_mesh(1, EP_RANKS))`` held to the same prefill
    in ``moe_mode="replicated"`` under the same policy and timed beside a
    prefill without a policy, EP_DECODE decode steps under a policy with
    ``seq_sharded=False``, and the loss's gradient at EP_GRAD_LAYERS
    layers against replicated mode's; the prefill and decode there run
    under ``use_policy`` on the whole weights (split every call).  (c)
    the three Slice 3b self-tests with ``--device cuda``.

    Slice 3c, the parameters at rest as per-rank shards: (d) the policy's
    ``make_train_step`` at (a)'s size on FSDP_MESH ranks, held to (a)'s
    single stream (bit for bit, printed; else within 2e-4), its copies,
    bytes and resident bytes a rank the closed forms; (e) the same at
    h2o-danube-1.8b's published depth for FSDP_FULL_STEPS steps: losses,
    every shard's step-1 gradient finite and non-zero, the launches by
    route, warm wall, model FLOP/s, busy share, peak memory and resident
    bytes; (f) (b)'s prefill through ``make_prefill_step`` under the
    policy, the weights at rest (the experts on the expert axis): logits
    bit for bit (b)'s, the expert splits gone, splits and copies the
    closed forms, wall and busy share; (g) TP_DECODE decode steps under
    ``params_tp=True``: logits within the bf16 limits of decode without
    a policy, copies a step the closed form, ms a step.  Returns the
    launches by route of the last DP step, the FSDP steps, an EP prefill
    and the EP gradient, and the numbers printed."""
    import contextlib
    import dataclasses
    import importlib
    import io

    from repro_torch import configs
    from repro_torch.core import spmd
    from repro_torch.core.spmd import make_mesh
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.meter_gradsync import (expected_copies,
                                                  fsdp_expected_copies,
                                                  gradient_leaves,
                                                  moe_expected_splits,
                                                  serving_expected_copies)
    from repro_torch.models import LanguageModel
    from repro_torch.optim import AdamW
    from repro_torch.sharding import make_policy, unplace, use_policy
    from repro_torch.train import make_prefill_step, make_decode_step
    from repro_torch.train.step import (init_error_state,
                                        make_manual_dp_train_step,
                                        make_train_step)

    out = {}
    plain = dict.fromkeys(("attention", "attention_lse", "attention_grad",
                           "attention_grad_lse"), 0)
    originals = {name: getattr(fa_ref, name) for name in plain}
    attend = fa_ops._attend
    backward = fa_ops._Attention.__dict__["backward"]
    held = {"fwd": 0, "bwd": 0, "fwd_err": 0.0, "bwd_nrms": 0.0,
            "bwd_err": 0.0, "shapes": set()}

    def counting(name):
        def wrapper(*args, **kwargs):
            plain[name] += 1
            return originals[name](*args, **kwargs)
        return wrapper

    def attend_held(q, k, v, *, causal, window, scale, lse):
        # the path's forward, held to the plain version on its inputs
        out_, rows = attend(q, k, v, causal=causal, window=window,
                            scale=scale, lse=lse)
        exp = originals["attention"](q, k, v, causal=causal, window=window,
                                     scale=scale)
        tol = ATTN_TOL[str(q.dtype).split(".")[-1]]
        diff = (out_.double() - exp.double()).abs()
        check(bool(torch.isfinite(out_).all())
              and bool((diff <= tol + tol * exp.double().abs()).all()),
              f"[lm_mesh] attention forward {tuple(q.shape)}: beyond rtol "
              f"{tol} atol {tol} of the plain version (largest error "
              f"{float(diff.max()):.3e})")
        held["fwd"] += 1
        held["fwd_err"] = max(held["fwd_err"], float(diff.max()))
        held["shapes"].add((tuple(q.shape), tuple(k.shape), str(q.dtype),
                            causal, window))
        return out_, rows

    def bwd_held(ctx, dout):
        # what _Attention.backward does, held to the plain version
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        got = fa_ops.flash_attention_bwd(q, k, v, o, dout, lse=lse,
                                         causal=causal, window=window,
                                         scale=scale)
        exp = originals["attention_grad"](q, k, v, dout, causal=causal,
                                          window=window, scale=scale)
        for name, g, e in zip(("dq", "dk", "dv"), got, exp):
            nrms = slice_nrms(g, e)
            check(bool(torch.isfinite(g).all()) and nrms <= BWD_F32_NRMS,
                  f"[lm_mesh] attention backward {name} {tuple(q.shape)}: "
                  f"rms error per head slice {nrms:.3e} of the plain "
                  f"version's (> {BWD_F32_NRMS:.3e})")
            held["bwd_nrms"] = max(held["bwd_nrms"], nrms)
            held["bwd_err"] = max(held["bwd_err"], (g.double() - e.double())
                                  .abs().max().item())
        held["bwd"] += 1
        return (*got, None, None, None, None)

    def routes():
        return {"flash_attention": dict(fa_ops.flash_attention.routes),
                "flash_attention_bwd": dict(fa_ops.flash_attention_bwd.routes)}

    def attention_time(label, prof) -> float:
        """Print a profiled step's attention kernels, by name, launches
        and ms a launch; returns their device time in ms."""
        attn = [(ms, n, re.search(r"(\w+_kernel(<[^>]*>)?)", key).group(1))
                for ms, n, key in prof["kernels"] if "attention" in key]
        total = sum(ms for ms, _n, _k in attn)
        print(f"{label}: attention device time {total:.3f} ms of "
              f"{prof['total']:.3f}: " + "; ".join(
                  f"{name} {n} x {ms / n:.3f} ms" for ms, n, name in attn))
        return total

    def fsdp_run(cfg, label, data, want_kernels, steps, single=None):
        """The policy's step on FSDP_MESH ranks sharing the card, its
        parameters, masters and moments at rest as per-rank shards: every
        step's launches by route (no plain version), copies and bytes the
        closed form, step 1's every shard gradient finite and non-zero,
        the per-rank resident bytes the closed form (each leaf's global
        elements over its distinct blocks); with ``single`` (the
        policy-free run's ``(losses, params, first moments)``) held to it
        bit for bit (else within the DP step's 2e-4, printed), and every
        attention call of step 1 held to its plain version on its own
        inputs (the single stream launches the same kernel, so the bits
        alone would not see a fault of it).  Returns the numbers it
        prints."""
        model = LanguageModel(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(SEED))
        n_params = model.param_count()
        policy = make_policy(make_host_mesh(*FSDP_MESH, device=dev))
        mesh = policy.mesh
        first = {}

        class Watching(AdamW):
            def update(self, grads, state, params, **kw):
                if state.count == 0:
                    for name, g in grads.items():
                        ok = (bool(torch.isfinite(g).all())
                              and bool((g != 0).any()))
                        first[name] = first.get(name, True) and ok
                return super().update(grads, state, params, **kw)

        opt = Watching(learning_rate=DP_LR)
        step = make_train_step(model, opt, policy)
        placement = model.placement
        state = opt.init(model)
        whole_bytes = sum(p.numel() * p.element_size()
                          for p in model.parameters())
        # a rank holds each leaf's global elements over its distinct
        # blocks, and a float32 master and two moments beside each
        want_rank = sum(
            math.prod(v.global_shape) // len(spmd.block_ranks(mesh, v.spec))
            * (v.shards[0].element_size() + 12)
            for v in placement.params.values())
        got_rank = [sum(v.shards[r].numel() * v.shards[r].element_size()
                        for tree in (placement.params, state.master,
                                     state.m, state.v)
                        for v in tree.values()) for r in range(mesh.size)]
        check(got_rank == [want_rank] * mesh.size, f"{label}: resident "
              f"bytes a rank {got_rank}, the closed form {want_rank}")
        replicated = sum(v.shards[0].numel() * (v.shards[0].element_size()
                                                + 12)
                         for v in placement.params.values() if
                         all(e is None for e in v.spec))
        n_copies, n_bytes = fsdp_expected_copies(
            model, policy, tokens=DP_BATCH * DP_SEQ)
        losses, walls = [], []
        for name_ in plain:
            setattr(fa_ref, name_, counting(name_))
        try:
            for i in range(steps):
                batch = data.batch_at(i)
                zero_counts()
                for key in plain:
                    plain[key] = 0
                c0, b0 = mesh.copies, mesh.bytes_copied
                hold = single is not None and i == 0
                if hold:
                    held.update(fwd=0, bwd=0, fwd_err=0.0, bwd_nrms=0.0,
                                bwd_err=0.0, shapes=set())
                    fa_ops._attend = attend_held
                    fa_ops._Attention.backward = staticmethod(bwd_held)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    state, metrics = step(state, batch)
                finally:
                    fa_ops._attend = attend
                    fa_ops._Attention.backward = backward
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                got, by_route = counts(), routes()
                losses.append(float(metrics["loss"]))
                if hold:
                    n_fwd = want_kernels["flash_attention"][DP_ROUTE]
                    n_bwd = want_kernels["flash_attention_bwd"][DP_ROUTE]
                    check(held["fwd"] == n_fwd and held["bwd"] == n_bwd,
                          f"{label}: held {held['fwd']} forward and "
                          f"{held['bwd']} backward attention calls, "
                          f"expected {n_fwd} and {n_bwd}")
                    print(f"{label} step 1: every attention call held to "
                          f"its plain version on the same inputs, "
                          f"{held['fwd']} forward (q, k, dtype, causal, "
                          f"window: {sorted(held['shapes'])}; max_abs_err "
                          f"{held['fwd_err']:.3e} within rtol and atol "
                          f"{ATTN_TOL['float32']}) and {held['bwd']} "
                          f"backward (rms error per head slice "
                          f"{held['bwd_nrms']:.3e} <= {BWD_F32_NRMS:.0e}, "
                          f"max_abs_err {held['bwd_err']:.3e}) ({card})")
                check(by_route == want_kernels, f"{label} step {i + 1}: "
                      f"launches by route {by_route}, expected "
                      f"{want_kernels}")
                others = {k: v for k, v in got.items() if v and k not in
                          want_kernels}
                check(not others, f"{label}: unexpected launches {others}")
                check(not any(plain.values()), f"{label}: plain versions "
                      f"called {plain}")
                check((mesh.copies - c0, mesh.bytes_copied - b0)
                      == (n_copies, n_bytes),
                      f"{label} step {i + 1}: {mesh.copies - c0} copies of "
                      f"{mesh.bytes_copied - b0} bytes, the closed form "
                      f"{n_copies} of {n_bytes}")
        finally:
            for name_, fn in originals.items():
                setattr(fa_ref, name_, fn)
        check(all(math.isfinite(x) for x in losses), f"{label}: losses "
              f"{losses}")
        bad = [n for n in placement.params if not first.get(n)]
        check(not bad, f"{label}: step 1 shard gradients zero, missing or "
              f"not finite {bad[:6]}")
        out = {"losses": losses, "walls": walls, "copies": n_copies,
               "gib": n_bytes / 2 ** 30, "rank_bytes": want_rank,
               "replicated_bytes": replicated, "whole_bytes": whole_bytes,
               "n_params": n_params, "routes": by_route}
        if single is not None:
            want_losses, want, want_m = single
            bitwise = losses == want_losses
            worst = 0.0
            with torch.no_grad():
                for n, v in placement.params.items():
                    g = spmd.assemble(v)
                    bitwise &= torch.equal(g, want[n])
                    diff = (g - want[n]).abs() - 2e-4 * want[n].abs()
                    worst = max(worst, float(diff.max()))
                    m_n = spmd.assemble(state.m[n])
                    bitwise &= torch.equal(m_n, want_m[n])
                    del g, diff, m_n
            check(bitwise or worst <= 2e-4, f"{label}: parameters "
                  f"{worst:.3e} beyond rtol 2e-4 of the policy-free step "
                  f"(atol 2e-4)")
            out["bitwise"], out["worst"] = bitwise, worst
        warm = min(walls[1:])
        out["warm_s"] = warm
        prof = {}
        out["busy"] = device_profile(
            torch, label, lambda: step(state, data.batch_at(steps)), warm,
            {}, found=prof)
        out["attention_ms"] = attention_time(label, prof)
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        del model, step, state, metrics, placement, opt
        return out

    # -- (a) explicit data parallelism ---------------------------------------
    base = memory_base(torch, dev)
    cfg = dataclasses.replace(configs.get(DP_ARCH), n_layers=DP_LAYERS,
                              dtype="float32")
    label = f"[lm_mesh] {cfg.name}"
    data = SyntheticLMDataset(cfg.vocab_size, DP_SEQ, DP_BATCH, seed=SEED,
                              device=dev)
    opt = AdamW(learning_rate=DP_LR)

    def fresh():
        return LanguageModel(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(SEED))

    single = fresh()
    n_params = single.param_count()
    n_elems = sum(p.numel() for p in single.parameters())
    step = make_train_step(single, opt)
    state = opt.init(single)
    losses, walls = [], []
    for i in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, data.batch_at(i))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    single_warm = min(walls[1:])
    single_losses = list(losses)
    want = {n: p.detach() for n, p in single.named_parameters()}
    want_m = state.m
    del state, step, metrics
    print(f"{label}: {cfg.n_layers} of {configs.get(DP_ARCH).n_layers} "
          f"layers at the published widths (d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads at d {cfg.head_dim_}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, window {cfg.window}), "
          f"float32, {n_params:,} parameters in weight matrices; single "
          f"stream (make_train_step, remat): losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}; step walls "
          f"{', '.join(f'{w:.4f}' for w in walls)} s ({card})")
    dp_out, last_routes = {}, None
    for name, shape, axes, schedule, compress in DP_RUNS:
        run_label = f"{label} {name} on {dict(zip(axes, shape))}"
        model = fresh()
        mesh = make_mesh(shape, axes, (dev,) * math.prod(shape))
        step = make_manual_dp_train_step(model, opt, mesh, schedule=schedule,
                                         data_axes=axes,
                                         compress_outer=compress)
        state, err = opt.init(model), init_error_state(model)
        n_copies, n_bytes = expected_copies(schedule, compress,
                                            dict(zip(axes, shape)),
                                            gradient_leaves(model))
        losses, walls = [], []
        for name_ in plain:
            setattr(fa_ref, name_, counting(name_))
        try:
            for i in range(DP_STEPS):
                batch = data.batch_at(i)
                zero_counts()
                for key in plain:
                    plain[key] = 0
                c0, b0 = mesh.copies, mesh.bytes_copied
                # the first run's first step holds every attention call
                hold = name == DP_RUNS[0][0] and i == 0
                if hold:
                    fa_ops._attend = attend_held
                    fa_ops._Attention.backward = staticmethod(bwd_held)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    state, loss, err = step(state, batch, err)
                finally:
                    fa_ops._attend = attend
                    fa_ops._Attention.backward = backward
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                got, by_route = counts(), routes()
                last_routes = by_route
                losses.append(float(loss))
                if hold:
                    n_calls = DP_KERNELS["flash_attention"][DP_ROUTE]
                    check(held["fwd"] == n_calls and held["bwd"] == n_calls,
                          f"{run_label}: held {held['fwd']} forward and "
                          f"{held['bwd']} backward attention calls, "
                          f"expected {n_calls} each")
                    print(f"{run_label} step 1: every attention call held to "
                          f"its plain version on the same inputs, "
                          f"{held['fwd']} forward (q, k, dtype, causal, "
                          f"window: {sorted(held['shapes'])}; max_abs_err "
                          f"{held['fwd_err']:.3e} within rtol and atol "
                          f"{ATTN_TOL['float32']}) and {held['bwd']} backward "
                          f"(rms error per head slice {held['bwd_nrms']:.3e} "
                          f"<= {BWD_F32_NRMS:.0e}, max_abs_err "
                          f"{held['bwd_err']:.3e}) ({card})")
                check(by_route == DP_KERNELS, f"{run_label} step {i + 1}: "
                      f"launches by route {by_route}, expected {DP_KERNELS}")
                others = {k: v for k, v in got.items() if v and k not in
                          DP_KERNELS}
                check(not others, f"{run_label}: unexpected launches "
                      f"{others}")
                check(not any(plain.values()), f"{run_label}: plain versions "
                      f"called {plain}")
                check((mesh.copies - c0, mesh.bytes_copied - b0)
                      == (n_copies, n_bytes),
                      f"{run_label} step {i + 1}: {mesh.copies - c0} copies "
                      f"of {mesh.bytes_copied - b0} bytes, the schedule "
                      f"counts {n_copies} of {n_bytes}")
                unequal = [n for tree in (step.params, state.master, state.m,
                                          state.v)
                           for n, v in tree.items()
                           if not all(torch.equal(t, v.shards[0])
                                      for t in v.shards[1:])]
                check(not unequal, f"{run_label} step {i + 1}: ranks differ "
                      f"in {unequal[:4]}")
        finally:
            for name_, fn in originals.items():
                setattr(fa_ref, name_, fn)
        rtol, atol = (5e-2, 5e-3) if compress else (2e-4, 2e-4)
        worst, beyond, moved = _params_beyond(torch, model, want, rtol, atol)
        if compress:
            # Adam turns a near-zero gradient's quantisation error into a
            # whole step of either sign: the reference's elementwise bound
            # holds on all but a few elements of 302.8 M, and none moves
            # further than every step the other way
            cap = 2 * DP_STEPS * DP_LR + atol
            check(beyond <= n_elems * DP_INT8_BEYOND and moved <= cap,
                  f"{run_label}: {beyond} parameters beyond rtol {rtol} + "
                  f"atol {atol} of the single stream (at most "
                  f"{n_elems * DP_INT8_BEYOND:.0f}), the largest difference "
                  f"{moved:.3e} (at most {cap:.3e})")
            flipped = _flipped_moments(torch, model, state.m, want, want_m,
                                       rtol, atol)
            print(f"{run_label}: {beyond} elements beyond the bound, "
                  f"{flipped} of them with a first moment of the other sign "
                  f"than the single stream's; the largest difference "
                  f"{moved:.3e} of at most {cap:.3e} ({card})")
        else:
            check(worst <= atol, f"{run_label}: parameters {worst:.3e} "
                  f"beyond rtol {rtol} of the single stream (atol {atol})")
        if compress:
            big = max(float(e.shards[0].abs().max()) for e in err.values())
            check(big < 1.0, f"{run_label}: error feedback {big}")
        warm = min(walls[1:])
        prof = {}
        busy = device_profile(
            torch, run_label, lambda: step(state, data.batch_at(DP_STEPS),
                                           err), warm, {}, found=prof)
        attention_time(run_label, prof)
        gib = n_bytes / 2 ** 30
        print(f"{run_label}: losses {', '.join(f'{x:.5f}' for x in losses)}; "
              f"parameters within rtol {rtol} + {worst:.3e} of the single "
              f"stream (atol {atol}; {beyond} of {n_elems:,} elements "
              f"beyond it; the largest difference {moved:.3e}, "
              f"{moved / DP_LR:.2f} lr); every rank's replica, masters and "
              f"moments bit for bit rank 0's after every step; a step "
              f"{n_copies} copies, {gib:.3f} GiB ({n_bytes / mesh.size:,.0f} "
              f"bytes a rank), the schedule's count; launches a step "
              f"{DP_KERNELS}, no plain version; step walls "
              f"{', '.join(f'{w:.4f}' for w in walls)} s, warm {warm:.4f} s "
              f"(the single stream's {single_warm:.4f} s); busy "
              f"{busy:.1f}% ({card})")
        dp_out[name] = {"warm_s": warm, "busy": busy, "copies": n_copies,
                        "gib": gib}
        del model, step, state, err, loss, got, mesh
    out["dp_step"] = {k: dict(v) for k, v in last_routes.items()}
    out["dp"] = dp_out

    # -- (d) the policy's step, parameters and AdamW state at rest -----------
    run_label = f"{label} FSDP on {dict(zip(('data', 'model'), FSDP_MESH))}"
    fsdp = fsdp_run(cfg, run_label, data, FSDP_KERNELS, DP_STEPS,
                    single=(single_losses, want, want_m))
    print(f"{run_label}: make_train_step under make_policy(make_host_mesh"
          f"{FSDP_MESH}), parameters, masters and moments at rest as "
          f"per-rank shards ({fsdp['rank_bytes']:,} bytes a rank, the "
          f"closed form: a quarter of every sharded leaf, "
          f"{fsdp['replicated_bytes']:,} of replicated small leaves, against "
          f"{4 * fsdp['whole_bytes']:,} for the whole with AdamW state); "
          f"losses {', '.join(f'{x:.5f}' for x in fsdp['losses'])}; bit for "
          f"bit the policy-free step's parameters, first moments and losses: "
          f"{fsdp['bitwise']} (largest beyond rtol 2e-4: "
          f"{fsdp['worst']:.3e}); every shard's gradient finite and non-zero "
          f"at step 1; a step {fsdp['copies']} copies, {fsdp['gib']:.3f} GiB "
          f"(the closed form: each leaf gathered in the forward and again in "
          f"the remat recompute, its gradient split once); launches a step "
          f"{fsdp['routes']} (each layer's attention once on the whole batch "
          f"and again in the recompute, its backward once), no plain "
          f"version; step walls {', '.join(f'{w:.4f}' for w in fsdp['walls'])}"
          f" s, warm {fsdp['warm_s']:.4f} s (the single stream's "
          f"{single_warm:.4f} s); busy {fsdp['busy']:.1f}% ({card})")
    out["fsdp_step"] = {k: dict(v) for k, v in fsdp["routes"].items()}
    out["fsdp"] = {k: fsdp[k] for k in ("warm_s", "busy", "copies", "gib",
                                         "rank_bytes", "bitwise")}
    del single, want, want_m
    memory_back(torch, dev, base, f"{label} data parallel and FSDP")

    # -- (e) FSDP at full depth: what the DP replicas cannot hold ------------
    base = memory_base(torch, dev)
    full_cfg = dataclasses.replace(configs.get(DP_ARCH), dtype="float32")
    run_label = (f"[lm_mesh] {full_cfg.name} full depth FSDP on "
                 f"{dict(zip(('data', 'model'), FSDP_MESH))}")
    n_full = full_cfg.n_layers
    full_kernels = {"flash_attention": {DP_ROUTE: 2 * n_full},
                    "flash_attention_bwd": {DP_ROUTE: n_full}}
    full = fsdp_run(full_cfg, run_label, data, full_kernels, FSDP_FULL_STEPS)
    tokens = DP_BATCH * DP_SEQ
    flops = 6 * full["n_params"] * tokens
    dp_need = FSDP_MESH[0] * FSDP_MESH[1] * 4 * full["whole_bytes"]
    print(f"{run_label}: {n_full} layers at the published widths, float32, "
          f"{full['n_params']:,} parameters in weight matrices, "
          f"{DP_BATCH} x {DP_SEQ} tokens, {FSDP_FULL_STEPS} AdamW steps: "
          f"losses {', '.join(f'{x:.5f}' for x in full['losses'])}; every "
          f"shard's gradient finite and non-zero at step 1; launches a step "
          f"{full['routes']} ({n_full} forward, {n_full} again in the remat "
          f"recompute, {n_full} backward: the activations are whole, so each "
          f"layer runs once a pass, not once a rank); a step "
          f"{full['copies']} copies, {full['gib']:.3f} GiB; step walls "
          f"{', '.join(f'{w:.4f}' for w in full['walls'])} s, warm "
          f"{full['warm_s']:.4f} s, {flops / full['warm_s'] / 1e12:.2f} "
          f"model TFLOP/s (6 N T / wall); busy {full['busy']:.1f}%; peak "
          f"memory {full['peak_gb']:.2f} GB; resident "
          f"{full['rank_bytes'] / 1e9:.3f} GB a rank of parameters, "
          f"masters and moments "
          f"({4 * full['rank_bytes'] / 1e9:.3f} GB on the card), against "
          f"{dp_need / 1e9:.1f} GB for {FSDP_MESH[0] * FSDP_MESH[1]} DP "
          f"replicas with their AdamW state ({card})")
    out["fsdp_full_step"] = {k: dict(v) for k, v in full["routes"].items()}
    out["fsdp_full"] = {k: full[k] for k in ("warm_s", "busy", "copies",
                                              "gib", "rank_bytes", "peak_gb")}
    out["fsdp_full"]["model_tflops"] = flops / full["warm_s"] / 1e12
    memory_back(torch, dev, base, f"{run_label}")

    # -- (b) expert parallelism ----------------------------------------------
    base = memory_base(torch, dev)
    full = configs.get(EP_ARCH)
    cfg = dataclasses.replace(full, n_layers=EP_LAYERS)
    rep_cfg = dataclasses.replace(cfg, moe_mode="replicated")
    label = f"[lm_mesh] {cfg.name}"
    model = LanguageModel(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    mesh = make_host_mesh(1, EP_RANKS, device=dev)
    policy = make_policy(mesh)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (EP_BATCH, EP_PROMPT),
                           generator=gen, device=dev)
    s_max = EP_PROMPT + EP_DECODE

    def prefill(tokens):
        # the split-per-call path: the whole weights under the policy, so
        # every call splits the expert weights for its shard_map
        with use_policy(policy):
            return model.prefill(tokens, s_max=s_max)

    def timed_prefill(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, states = fn(tokens)
        torch.cuda.synchronize()
        return logits, states, time.perf_counter() - t0

    timed_prefill(prefill)                        # cold
    for name_ in plain:
        setattr(fa_ref, name_, counting(name_))
    try:
        zero_counts()
        for key in plain:
            plain[key] = 0
        c0, b0 = mesh.copies, mesh.bytes_copied
        s0, sb0 = mesh.splits, mesh.bytes_split
        logits, states, t_ep = timed_prefill(prefill)
        got, by_route = counts(), routes()
    finally:
        for name_, fn in originals.items():
            setattr(fa_ref, name_, fn)
    ep_copies, ep_bytes = mesh.copies - c0, mesh.bytes_copied - b0
    ep_splits = (mesh.splits - s0, mesh.bytes_split - sb0)
    check(ep_splits == moe_expected_splits(model, policy, batch=EP_BATCH,
                                           seq=EP_PROMPT, at_rest=False),
          f"{label}: {ep_splits} splits (count, bytes) a prefill")
    check(by_route["flash_attention"] == EP_KERNELS
          and got["flash_attention"] == EP_LAYERS,
          f"{label}: launches by route {by_route}, expected {EP_KERNELS} a "
          f"prefill")
    others = {k: v for k, v in got.items() if v and k != "flash_attention"}
    check(not others, f"{label}: unexpected launches {others}")
    check(not any(plain.values()), f"{label}: plain versions called {plain}")
    check(bool(torch.isfinite(logits).all()), f"{label}: EP logits not "
          f"finite")
    # tokens cross the model axis twice a layer: n (n - 1) copies each, and
    # aux's ring pmean 2 n (n - 1)
    n = EP_RANKS
    check(ep_copies == EP_LAYERS * (2 * n * (n - 1) + 2 * n * (n - 1)),
          f"{label}: {ep_copies} copies a prefill")
    ep_busy = device_profile(torch, f"{label} EP prefill",
                             lambda: prefill(tokens), t_ep, {})
    c1 = mesh.copies
    model.cfg = rep_cfg
    try:
        rep_logits, rep_states, t_rep = timed_prefill(prefill)
        rep_copies = mesh.copies - c1
    finally:
        model.cfg = cfg
    del rep_states
    rtol, atol = TOL["bfloat16"]
    err_ep = (logits.float() - rep_logits.float()).abs()
    lim = atol + rtol * rep_logits.float().abs()
    check(bool((err_ep <= lim).all()), f"{label}: EP logits beyond the bf16 "
          f"limits of replicated mode's (largest error {float(err_ep.max())})")
    plain_prefill = make_prefill_step(model, s_max=s_max)
    timed_prefill(plain_prefill)
    t_plain = timed_prefill(plain_prefill)[2]
    ep_logits = logits.clone()
    print(f"{label}: {EP_LAYERS} of {full.n_layers} layers at the published "
          f"widths ({cfg.n_experts} experts top-{cfg.n_experts_active}, "
          f"expert d_ff {cfg.d_ff}), bf16, prefill {EP_BATCH} x {EP_PROMPT} "
          f"under make_policy(make_host_mesh(1, {n})): {cfg.n_experts // n} "
          f"experts a rank, two all_to_all a MoE layer; the whole weights "
          f"split every call ({ep_splits[0]} splits of "
          f"{ep_splits[1] / 2 ** 30:.3f} GiB, the closed form); {ep_copies} "
          f"copies of {ep_bytes / 2 ** 30:.3f} GiB a prefill ({ep_bytes:,} "
          f"bytes); "
          f"launches {by_route['flash_attention']}, no plain version; "
          f"logits within the bf16 limits of moe_mode='replicated' under "
          f"the same policy (largest error {float(err_ep.max()):.3e}; "
          f"replicated {rep_copies} copies, aux's pmean only); walls: EP "
          f"{t_ep:.4f} s (busy {ep_busy:.1f}%), replicated {t_rep:.4f} s, "
          f"no policy {t_plain:.4f} s ({card})")
    del rep_logits, err_ep, lim, plain_prefill
    dec_policy = make_policy(make_host_mesh(1, n, device=dev),
                             seq_sharded=False)
    def decode(states, token, pos):
        # split per call, as the prefill above
        with use_policy(dec_policy):
            return model.decode_step(states, token, pos)

    token = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(EP_DECODE):
        logits, states = decode(states, token, EP_PROMPT + t)
        token = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()), f"{label}: decode logits")
    print(f"{label}: {EP_DECODE} decode steps under a policy with "
          f"seq_sharded=False (capacity = the rank's tokens): "
          f"{t_dec / EP_DECODE * 1e3:.3f} ms a step, "
          f"{dec_policy.mesh.copies} copies in all ({card})")
    out["ep_prefill"] = {"flash_attention": dict(by_route["flash_attention"])}
    out["ep"] = {"prefill_s": t_ep, "busy": ep_busy,
                 "replicated_s": t_rep, "no_policy_s": t_plain,
                 "copies": ep_copies, "gib": ep_bytes / 2 ** 30,
                 "splits": ep_splits[0], "split_gib": ep_splits[1] / 2 ** 30,
                 "decode_ms": t_dec / EP_DECODE * 1e3}
    del decode, states, logits, token

    # -- (f) the same prefill with the experts at rest on the expert axis ----
    rest_prefill = make_prefill_step(model, policy, s_max=s_max)
    timed_prefill(rest_prefill)                   # cold
    for name_ in plain:
        setattr(fa_ref, name_, counting(name_))
    try:
        zero_counts()
        for key in plain:
            plain[key] = 0
        c0, b0 = mesh.copies, mesh.bytes_copied
        s0, sb0 = mesh.splits, mesh.bytes_split
        logits, states, t_rest = timed_prefill(rest_prefill)
        got, by_route = counts(), routes()
    finally:
        for name_, fn in originals.items():
            setattr(fa_ref, name_, fn)
    rest_copies = (mesh.copies - c0, mesh.bytes_copied - b0)
    rest_splits = (mesh.splits - s0, mesh.bytes_split - sb0)
    check(by_route["flash_attention"] == EP_KERNELS
          and not {k: v for k, v in got.items()
                   if v and k != "flash_attention"}
          and not any(plain.values()),
          f"{label} at rest: launches {got} by route {by_route}, plain "
          f"{plain}")
    check(torch.equal(logits, ep_logits), f"{label} at rest: logits differ "
          f"from the split-per-call path's (largest "
          f"{float((logits.float() - ep_logits.float()).abs().max())})")
    want_splits = moe_expected_splits(model, policy, batch=EP_BATCH,
                                      seq=EP_PROMPT, at_rest=True)
    check(rest_splits == want_splits
          and ep_splits[0] - rest_splits[0] == 3 * n * EP_LAYERS,
          f"{label} at rest: {rest_splits} splits a prefill, the closed "
          f"form {want_splits}")
    want_copies = serving_expected_copies(model, policy,
                                          tokens=EP_BATCH * EP_PROMPT,
                                          decode=False)
    check(rest_copies == want_copies, f"{label} at rest: {rest_copies} "
          f"copies a prefill, the closed form {want_copies}")
    rest_busy = device_profile(torch, f"{label} EP prefill at rest",
                               lambda: rest_prefill(tokens), t_rest, {})
    rank_gb = model.placement.rank_bytes()[0] / 1e9
    print(f"{label}: the prefill with the weights at rest "
          f"(make_prefill_step under the policy: flat FSDP, the experts on "
          f"the model axis, {rank_gb:.3f} GB a rank): logits bit for bit the "
          f"split-per-call path's; {rest_splits[0]} splits of "
          f"{rest_splits[1] / 2 ** 30:.3f} GiB a prefill (was "
          f"{ep_splits[0]} of {ep_splits[1] / 2 ** 30:.3f}: the "
          f"{3 * n * EP_LAYERS} expert-weight splits gone, the closed form); "
          f"{rest_copies[0]} copies of {rest_copies[1] / 2 ** 30:.3f} GiB "
          f"(the closed form: the {ep_copies} of the collectives and each "
          f"dense leaf's gather); wall {t_rest:.4f} s (busy "
          f"{rest_busy:.1f}%) against the split-per-call path's "
          f"{t_ep:.4f} s ({card})")
    out["ep"].update(rest_s=t_rest, rest_busy=rest_busy,
                     rest_splits=rest_splits[0],
                     rest_copies=rest_copies[0],
                     rest_gib=rest_copies[1] / 2 ** 30)
    del ep_logits

    # -- (g) decode with the weights TP-sharded at rest ----------------------
    # the reference first: decode without a policy on the whole weights,
    # before the TP placement exists, so no TP shard or gather reaches it
    free_states = _clone_tree(torch, states)
    unplace(model)
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    free_decode = make_decode_step(model)
    token = logits[:, -1].argmax(-1, keepdim=True)
    fed, free_out = [], []
    for t in range(TP_DECODE):
        free_logits, free_states = free_decode(free_states, token,
                                               EP_PROMPT + t)
        fed.append(token)
        free_out.append(free_logits)
        # both take the policy-free run's next token
        token = free_logits[:, -1].argmax(-1, keepdim=True)
    del free_states, free_decode
    tp_policy = make_policy(make_host_mesh(1, n, device=dev),
                            params_tp=True, seq_sharded=False)
    tp_decode = make_decode_step(model, tp_policy)
    moved = [name for name, v in model.placement.params.items()
             if not torch.equal(spmd.assemble(v), whole[name])]
    check(not moved, f"{label} TP decode: the weights placed by _tp_spec "
          f"do not assemble to the whole weights in {moved[:4]}")
    del whole
    tp_mesh = tp_policy.mesh
    want_step = serving_expected_copies(model, tp_policy, tokens=EP_BATCH,
                                        decode=True)
    walls, worst = [], 0.0
    rtol, atol = TOL["bfloat16"]
    for t in range(TP_DECODE):
        c0 = tp_mesh.copies
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, states = tp_decode(states, fed[t], EP_PROMPT + t)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(tp_mesh.copies - c0 == want_step[0], f"{label} TP decode step "
              f"{t + 1}: {tp_mesh.copies - c0} copies, the closed form "
              f"{want_step[0]}")
        free_logits = free_out[t]
        err = (logits.float() - free_logits.float()).abs()
        check(bool((err <= atol + rtol * free_logits.float().abs()).all()),
              f"{label} TP decode step {t + 1}: beyond the bf16 limits of "
              f"the decode without a policy (largest {float(err.max())})")
        worst = max(worst, float(err.max()))
    tp_ms = sorted(walls)[len(walls) // 2] * 1e3
    tp_leaves = sum(1 for v in model.placement.params.values()
                    if tp_policy.model_axis in v.spec)
    print(f"{label}: {TP_DECODE} decode steps under make_policy(..., "
          f"params_tp=True, seq_sharded=False), the weights at rest by "
          f"_tp_spec ({tp_leaves} leaves on the model axis, assembled bit "
          f"for bit the whole weights) and gathered at use: logits within "
          f"the bf16 limits of decode without a policy on the whole weights, "
          f"run before the TP placement (largest error {worst:.3e}); "
          f"{want_step[0]} copies of "
          f"{want_step[1] / 2 ** 30:.3f} GiB a step (the closed form); "
          f"median {tp_ms:.3f} ms a step ({card})")
    out["ep"].update(tp_decode_ms=tp_ms, tp_copies=want_step[0],
                     tp_gib=want_step[1] / 2 ** 30)
    del (model, prefill, rest_prefill, tp_decode, states, logits,
         free_logits, free_out, fed, token, tokens, err)
    memory_back(torch, dev, base, f"{label} expert-parallel serving")

    base = memory_base(torch, dev)
    cfg = dataclasses.replace(full, n_layers=EP_GRAD_LAYERS)
    model = LanguageModel(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    model.requires_grad_(True)
    data = SyntheticLMDataset(cfg.vocab_size, EP_GRAD_SEQ, 1, seed=SEED,
                              device=dev)
    batch = data.batch_at(0)
    grads = {}
    for mode in ("ep", "replicated"):
        model.cfg = dataclasses.replace(cfg, moe_mode=mode)
        zero_counts()
        with use_policy(policy):
            loss, metrics = model.loss(batch, remat=False)
            loss.backward()
        grads[mode] = {n: p.grad for n, p in model.named_parameters()}
        if mode == "ep":
            by_route = routes()
            check(by_route == {"flash_attention": {"bf16_wgmma":
                                                   EP_GRAD_LAYERS},
                               "flash_attention_bwd": {"bf16_wgmma":
                                                       EP_GRAD_LAYERS}},
                  f"{label} gradient: launches by route {by_route}")
            ep_loss = float(loss.detach())
        model.zero_grad(set_to_none=True)
    model.cfg = cfg
    experts = [n for n in grads["ep"] if ".experts." in n]
    bad = [n for n in experts if not bool(torch.isfinite(grads["ep"][n]).all())
           or float(grads["ep"][n].abs().max()) == 0.0]
    check(len(experts) == 3 * EP_GRAD_LAYERS and not bad,
          f"{label} gradient: expert weights without a finite non-zero "
          f"gradient {bad}")
    worst = _largest_share(torch, grads["ep"], grads["replicated"])
    check(worst <= TOL["bfloat16"][0], f"{label} gradient: EP against "
          f"replicated {worst:.3e} of a leaf's largest value")
    print(f"{label}: the loss and its gradient at {EP_GRAD_LAYERS} layers, B "
          f"1 x S {EP_GRAD_SEQ}, under the policy: loss {ep_loss:.4f}; every "
          f"expert weight a finite non-zero gradient; within {worst:.3e} of "
          f"each leaf's largest value of replicated mode's gradient "
          f"(<= {TOL['bfloat16'][0]}); launches {by_route} ({card})")
    out["ep_grad"] = by_route
    del model, grads, batch, data, loss, metrics
    memory_back(torch, dev, base, f"{label} expert-parallel gradient")

    # -- (c) the self-tests, their ranks sharing the card ---------------------
    for name in ("selftest_train_dp", "selftest_elastic", "meter_gradsync"):
        module = importlib.import_module(f"repro_torch.launch.{name}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = module.main(["--device", "cuda"])
        torch.cuda.synchronize()
        lines = buf.getvalue().splitlines()
        ok = rc == 0 and (lines[-1:] == ["OK"] if name.startswith("selftest")
                          else len(lines) == 4)
        check(ok, f"[lm_mesh] {name} --device cuda: rc {rc}, {lines[-3:]}")
        print(f"[lm_mesh] python -m repro_torch.launch.{name} --device cuda: "
              f"rc 0 in {time.perf_counter() - t0:.2f} s")
        if name == "meter_gradsync":
            for line in lines:
                row = json.loads(line)
                c = row["collectives"]
                print(f"[lm_mesh] meter {row['schedule']}: "
                      f"{c['ppermute']['count']:.0f} copies, "
                      f"{c['ppermute']['bytes']:,.0f} bytes a rank (the "
                      f"reference's wire model: "
                      f"{c['reference_wire_model']['total_bytes']:,.0f})")
    return out


# -- Slice 3a: the rank mesh — ship lowering, chains, the shard_map GEMM ----
DRYRUN_ARCH = "gemma_7b"          # (a): its three cells on 256 meta ranks
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_RANK_PARAMS = 67_049_472   # its parameter bytes a rank, the
                                  # reference's shard_shape sum
# train_4k is counted by depth (dryrun.trace_by_depth: 1 and 2 layers,
# extended to 28), a 256-rank trace at full depth taking ~50 s; its copies
# and argument bytes a rank must be the full-depth trace's (python -m
# repro_torch.launch.dryrun --arch gemma_7b --shape train_4k --mesh single)
DRYRUN_BY_DEPTH = ("train_4k",)
DRYRUN_TRAIN_COPIES = 165_745
DRYRUN_TRAIN_ARG_BYTES = 469_379_072
FSDP_COPIES = 213                 # [lm_mesh] (d)'s step: copies, bytes and
FSDP_GIB = 2.774                  # resident bytes a rank (the closed forms
FSDP_RANK_BYTES = 1_211_310_080   # of launch/meter_gradsync.py and (d))


def dryrun_phase(torch, dev, card: str, zero_counts, counts) -> dict:
    """``[dryrun]``: the dry run (``repro_torch.launch.dryrun``).

    (a) DRYRUN_ARCH's DRYRUN_SHAPES cells on the single-pod production
    mesh's 256 ``meta`` ranks, as ``python -m repro_torch.launch.dryrun``
    runs them (DRYRUN_BY_DEPTH's counted by depth, held to the full-depth
    trace's copies and argument bytes): trace time, FLOPs a device
    (metered) and argument bytes a rank printed, the serving cells'
    parameter bytes a rank the reference's (DRYRUN_RANK_PARAMS); no
    ``jax`` module in the process.
    (b) the dry run held to the card: ``[lm_mesh]`` (d)'s cell
    (h2o-danube-1.8b's widths, DP_LAYERS layers, float32, DP_BATCH x
    DP_SEQ tokens, FSDP_MESH ranks) traced once on ``meta`` ranks and run
    once on ranks sharing the card, the production step and the
    ``meter=True`` step each: the copies, bytes, cut blocks and resident
    bytes a rank equal on both and equal to the closed forms
    (``fsdp_expected_copies``: FSDP_COPIES copies, FSDP_GIB GiB,
    FSDP_RANK_BYTES bytes a rank); the metered step's FLOP count equal on
    both, and on the card it launches no kernel; the meta attention
    counters the closed form of a call times the launches the card run
    counted.  Returns the launches and counts for the result line."""
    import dataclasses
    import math

    from repro_torch import configs
    from repro_torch.core.spmd import make_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.meter_gradsync import fsdp_expected_copies
    from repro_torch.models import LanguageModel, blocks
    from repro_torch.sharding import make_policy

    out = {"cells": {}}
    for shape in DRYRUN_SHAPES:
        t0 = time.perf_counter()
        cell = dryrun.run_cell(DRYRUN_ARCH, shape, "single",
                               by_depth=shape in DRYRUN_BY_DEPTH)
        wall = time.perf_counter() - t0
        prod = cell["production"]
        check(cell["flops_per_device"] > 0 and prod["flops"] > 0,
              f"[dryrun] {shape}: no FLOPs counted")
        if cell["by_depth"]:
            got = (prod["collectives"]["copies"],
                   prod["argument_size_in_bytes"])
            check(got == (DRYRUN_TRAIN_COPIES, DRYRUN_TRAIN_ARG_BYTES),
                  f"[dryrun] {shape} by depth: copies and argument bytes a "
                  f"rank {got}, the full-depth trace's "
                  f"{(DRYRUN_TRAIN_COPIES, DRYRUN_TRAIN_ARG_BYTES)}")
        if cell["kind"] != "train":
            check(prod["rank_bytes"] == DRYRUN_RANK_PARAMS,
                  f"[dryrun] {shape}: {prod['rank_bytes']} parameter bytes "
                  f"a rank, the reference's {DRYRUN_RANK_PARAMS}")
        how = (" counted by depth (1 and 2 layers, extended in a line)"
               if cell["by_depth"] else "")
        print(f"[dryrun] {DRYRUN_ARCH} x {shape} x single ({cell['ranks']} "
              f"meta ranks){how}: trace {cell['trace_s']} s, metered "
              f"{cell['meter_trace_s']} s ({wall:.1f} s in all); FLOPs a "
              f"device {cell['flops_per_device']:.4e} metered, "
              f"{prod['flops'] / cell['ranks']:.4e} production; argument "
              f"bytes a rank {prod['argument_size_in_bytes']:,} (parameters"
              f"{' and AdamW state' if cell['kind'] == 'train' else ''} "
              f"{prod['rank_bytes']:,}), output {prod['output_size_in_bytes']:,}"
              f"; {prod['collectives']['copies']} copies, "
              f"{prod['collectives']['splits']} cut blocks")
        out["cells"][shape] = {
            "trace_s": cell["trace_s"], "meter_trace_s": cell["meter_trace_s"],
            "flops_per_device": cell["flops_per_device"],
            "argument_size_in_bytes": prod["argument_size_in_bytes"]}
    check("jax" not in sys.modules, "[dryrun] a jax module is loaded")
    print("[dryrun] no jax module is loaded in this process")

    # -- (b) the dry run held to the card ---------------------------------------
    base = memory_base(torch, dev)
    cfg = dataclasses.replace(configs.get(DP_ARCH), n_layers=DP_LAYERS,
                              dtype="float32")
    meta_mesh = make_mesh(FSDP_MESH, ("data", "model"),
                          ["meta"] * math.prod(FSDP_MESH))
    want = fsdp_expected_copies(LanguageModel(cfg, device="meta"),
                                make_policy(meta_mesh),
                                tokens=DP_BATCH * DP_SEQ)
    check(want[0] == FSDP_COPIES and round(want[1] / 2 ** 30, 3) == FSDP_GIB,
          f"[dryrun] fsdp_expected_copies gives {want}, not "
          f"{FSDP_COPIES} copies of {FSDP_GIB} GiB")
    keys = ("copies", "bytes_copied", "splits", "bytes_split", "rank_bytes",
            "argument_size_in_bytes", "output_size_in_bytes")
    runs = {}
    for meter in (False, True):
        runs["meta", meter] = dryrun.trace_step(
            cfg, "train", DP_SEQ, DP_BATCH, meta_mesh, meter=meter,
            remat=not meter)
        zero_counts()
        runs["card", meter] = dryrun.trace_step(
            cfg, "train", DP_SEQ, DP_BATCH,
            make_host_mesh(*FSDP_MESH, device=dev), meter=meter,
            remat=not meter, seed=SEED)
        got = counts()
        loss = float(runs["card", meter]["outputs"]["loss"])
        check(math.isfinite(loss), f"[dryrun] card step loss {loss}")
        meta, on_card = runs["meta", meter], runs["card", meter]
        differ = {k: (meta[k], on_card[k]) for k in keys
                  if meta[k] != on_card[k]}
        check(not differ, f"[dryrun] meter={meter}: meta and card differ "
              f"in {differ}")
        label = "meter=True" if meter else "production"
        if meter:
            check(not any(got.values()), f"[dryrun] the meter=True step "
                  f"launched {got}")
            check(meta["flops"] == on_card["flops"] > 0,
                  f"[dryrun] metered FLOPs: meta {meta['flops']}, card "
                  f"{on_card['flops']}")
        else:
            launches = {k: v for k, v in got.items() if v}
            check(set(launches) == {"flash_attention", "flash_attention_bwd"},
                  f"[dryrun] the card step launched {launches}")
            check((meta["copies"], meta["bytes_copied"]) == want,
                  f"[dryrun] {meta['copies']} copies of "
                  f"{meta['bytes_copied']} bytes, the closed form {want}")
            check(meta["rank_bytes"] == [FSDP_RANK_BYTES] * len(
                meta["rank_bytes"]), f"[dryrun] resident bytes a rank "
                f"{meta['rank_bytes']}, not {FSDP_RANK_BYTES}")
            window = blocks._window_of(cfg.block_pattern[0], cfg)
            one = (DP_BATCH * cfg.n_heads * cfg.head_dim_
                   * visible_pairs(DP_SEQ, window))
            fwd, bwd = (meta["kernel_flops"][k] for k in (
                "flash_attention", "flash_attention_bwd"))
            check(fwd == 4 * one * launches["flash_attention"]
                  and bwd == 10 * one * launches["flash_attention_bwd"],
                  f"[dryrun] meta attention operations {fwd} / {bwd}, the "
                  f"closed form {4 * one} / {10 * one} a call times the "
                  f"card's launches {launches}")
            out["launches"] = launches
            out["meta_flops"] = {"flash_attention": fwd,
                                 "flash_attention_bwd": bwd}
        print(f"[dryrun] {cfg.name} {DP_LAYERS} layers float32 "
              f"{DP_BATCH} x {DP_SEQ} on {FSDP_MESH} ranks, {label} step: "
              f"meta and card agree: {meta['copies']} copies of "
              f"{meta['bytes_copied'] / 2 ** 30:.3f} GiB, "
              f"{meta['splits']} cut blocks, {meta['rank_bytes'][0]:,} "
              f"resident bytes a rank; FLOP counter {meta['flops']:,} "
              f"(card {on_card['flops']:,}); card launches {got}; loss "
              f"{loss:.4f}; trace {meta['trace_s']:.1f} s meta, "
              f"{on_card['trace_s']:.1f} s card ({card})")
    out["meter_flops"] = runs["meta", True]["flops"]
    del runs, meta, on_card
    memory_back(torch, dev, base, "[dryrun]")
    return out


MESH_RANKS = 4            # Listing 1's 2 x 2 ranks, sharing the one card
SHARDMAP_MESH = (2, 4)    # the (p, q) rank mesh of selftest_distgemm.py
SHARDMAP_TOL = 1e-4       # relative Frobenius error against the dense A @ B
SHARDMAP_ITERS = 5
MESH_WARM_ROUNDS = 3      # warm walls of serial and each schedule: the best


def mesh_phase(torch, dev, bind, A, B, C_serial, card, same_bits, only,
               measured, chains) -> dict:
    """``[mesh]``: Listing 1 (``A @ B`` at n = N_LISTING, ib = IB, f32, 2 x
    2 ranks) on ``MeshBackend(devices=(dev,) * 4)`` — ship lowering armed,
    the four ranks sharing the card — once per ship schedule, cold then
    warm: C bit for bit ``C_serial``, the stats and transfer stream
    ``serial``'s, every tensor ship lowered (three copies each), 512
    ``f32_3xtf32`` launches, no body expression, every destination shard of
    the cold run storage of its own holding the payload's bits, the memory
    back; the warm run profiled (the GEMMs and the copies apart).  Then
    ``chains`` (label -> (run, wrapper, levels)) through
    ``MeshBackend(pallas="auto", devices=(dev,) * 4)``: one chain-kernel
    launch each, bit for bit ``serial``; ``distributed_gemm_shardmap`` on a
    (2, 4) rank mesh against the dense product, both schedules, timed
    beside it; the three self-tests with ``--device cuda``.  Returns the
    ``kernels`` line's additions."""
    import contextlib
    import importlib
    import io

    from repro_torch.core import lowering
    from repro_torch.core.spmd import make_mesh
    from repro_torch.kernels.gemm import ops as gemm_ops
    from repro_torch.linalg.distributed import (distributed_gemm_shardmap,
                                                run_distributed_gemm)

    base = memory_base(torch, dev)
    devices = (dev,) * MESH_RANKS
    n = A.shape[0]
    leaves = (n // IB) ** 3
    flops = 2 * n ** 3

    def listing1(backend):
        C, stats, _ = run_distributed_gemm(A, B, ib=IB, NP=2, NQ=2,
                                           device=dev, backend=backend)
        return C, stats

    def best_wall(run):
        """The best of MESH_WARM_ROUNDS warm walls of ``run``, each after
        a cyclic collection (host walls swing by tens of per cent)."""
        best = float("inf")
        for _ in range(MESH_WARM_ROUNDS):
            gc.collect()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = run()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
            del result
        return best

    # serial here, for its warm wall and its stats beside the armed runs
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C_s, s_stats = listing1("serial")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    serial_wall = best_wall(lambda: listing1("serial"))
    same_bits("[mesh] serial Listing 1 vs the serial run of section 5", C_s,
              C_serial)
    del C_s
    s_transfers = list(s_stats.transfers)
    s_facts = (s_stats.ops_executed, s_stats.message_count,
               s_stats.bytes_transferred, s_stats.wavefronts)
    # one ship schedule per version and wavefront; every payload of
    # Listing 1 on the card is a CUDA tensor, so every ship lowers
    ships = len({(t.version_key, t.wavefront) for t in s_transfers})
    print(f"[mesh] Listing 1 n={n} ib={IB} float32, 2 x 2 ranks: serial "
          f"walls {walls[0]:.4f} s cold, {walls[1]:.4f} s warm, "
          f"{serial_wall:.4f} s the best of {MESH_WARM_ROUNDS} warm; "
          f"{ships} ship schedules ({len(s_transfers)} transfers, "
          f"{s_stats.bytes_transferred} bytes) an iteration ({card})")

    def shard_checked(broadcast, tally):
        """``MeshBackend._broadcast_shards`` holding every result: each
        rank's shard storage of its own on the card, the root's the
        payload, every other one its bits."""
        def wrapper(payload, root):
            shards = broadcast(payload, root)
            check(shards is not None,
                  f"[mesh] a broadcast from rank {root}: simulated")
            storages = {s.untyped_storage().data_ptr() for s in shards}
            check(len(shards) == MESH_RANKS == len(storages)
                  and shards[root] is payload
                  and all(s.device == payload.device for s in shards),
                  f"[mesh] a broadcast from rank {root}: "
                  f"{len(storages)} storages for {len(shards)} shards")
            check(all(torch.equal(s, payload) for s in shards),
                  f"[mesh] a broadcast from rank {root}: a shard differs "
                  f"from the payload")
            tally[0] += 1
            return shards
        return wrapper

    # the device-to-device copies the same plan makes without a rank mesh:
    # fused's level loop (the one the mesh backend runs) copies out the
    # batched adds' shipped rows
    found = {}
    device_profile(torch, "listing1 fused (the copies' baseline)",
                   lambda: listing1("fused"), serial_wall,
                   {F32_KERNEL: leaves}, found)
    own_copies = sum(cnt for _ms, cnt, key in found["kernels"]
                     if "Memcpy DtoD" in key)
    own_ms = sum(ms for ms, _cnt, key in found["kernels"]
                 if "Memcpy DtoD" in key)
    print(f"[mesh] Listing 1 on fused: {own_copies} device-to-device "
          f"copies an iteration of its own (shipped rows copied out), "
          f"{own_ms:.3f} ms ({card})")
    out = {"ships": ships, "serial_wall_s": serial_wall, "walls_s": {},
           "copy_ms": {}, "copies": {}, "bytes_copied": {}}
    launches = {}
    for schedule in lowering.SHIP_SCHEDULES:
        label = f"listing1 mesh {schedule}"
        seen = {}
        checked = [0]

        def run(schedule=schedule, seen=seen, checked=checked):
            mb = bind.MeshBackend(devices=devices, schedule=schedule)
            if "backend" not in seen:   # the cold run: every shard held
                mb._broadcast_shards = shard_checked(mb._broadcast_shards,
                                                     checked)
            seen["backend"] = mb
            return listing1(mb)

        def describe(phase, result, got, wall, mallocs, label=label,
                     seen=seen, checked=checked):
            C, stats = result
            mb = seen["backend"]
            mesh = mb.mesh(MESH_RANKS)
            routes = dict(gemm_ops.matmul.routes)
            ratio = wall / serial_wall
            print(f"[mesh] {label} {phase}: wall {wall:.4f} s ({ratio:.2f}x "
                  f"serial's best warm {serial_wall:.4f} s; "
                  f"{flops / wall / 1e12:.3f} TFLOP/s), ships lowered "
                  f"{mb.ships_lowered} of {ships}, simulated "
                  f"{mb.ships_simulated}, {mesh.copies} copies of "
                  f"{mesh.bytes_copied} bytes, gemm.matmul launches "
                  f"{got['gemm.matmul']} by route {routes}, cudaMalloc "
                  f"calls {mallocs} ({card})")
            same_bits(f"{label} {phase}: C vs serial", C, C_serial)
            check(list(stats.transfers) == s_transfers,
                  f"{label}: transfer stream differs from serial")
            check((stats.ops_executed, stats.message_count,
                   stats.bytes_transferred, stats.wavefronts) == s_facts,
                  f"{label}: stats differ from serial")
            check(mb._active and mb._schedule_eff == schedule
                  and mb.ships_lowered == ships
                  and mb.ships_simulated == 0
                  and mesh.copies == (MESH_RANKS - 1) * ships,
                  f"{label}: {mb.ships_lowered} ships lowered, "
                  f"{mb.ships_simulated} simulated, {mesh.copies} copies "
                  f"({ships} ships)")
            check(routes == {F32_ROUTE: leaves},
                  f"{label}: GEMM launches by route {routes}, expected "
                  f"{leaves} on {F32_ROUTE}")
            only(label, got, "gemm.matmul", leaves)
            if phase == "cold":
                check(checked[0] == ships, f"{label}: {checked[0]} "
                      f"broadcasts held of {ships}")
                print(f"[mesh] {label} cold: each of the {ships} "
                      f"broadcasts gave {MESH_RANKS} shards of distinct "
                      f"storage on {dev}, each the payload's bits")
            out["copies"][schedule] = mesh.copies
            out["bytes_copied"][schedule] = mesh.bytes_copied

        _kept, got, walls = measured(label, run, describe)
        launches[schedule] = got["gemm.matmul"]
        best = best_wall(run)
        out["walls_s"][schedule] = best
        print(f"[mesh] {label}: the best of {MESH_WARM_ROUNDS} warm walls "
              f"{best:.4f} s, {best / serial_wall:.2f}x serial's "
              f"{serial_wall:.4f} s ({card})")
        found = {}
        n_copies = (MESH_RANKS - 1) * ships
        busy = device_profile(
            torch, label, run, walls["warm"],
            {F32_KERNEL: leaves,
             "Memcpy DtoD": own_copies + n_copies}, found)
        # the ppermute copies' time: the copies' time less fused's own
        copy_ms = found["Memcpy DtoD"][0] - own_ms
        check(copy_ms > 0, f"{label}: the copies took {found['Memcpy DtoD']}"
              f", fused's own {own_ms} ms")
        fill_ms = sum(ms for ms, _cnt, key in found["kernels"]
                      if "FillFunctor" in key)
        out["copy_ms"][schedule] = copy_ms
        each_s = copy_ms / n_copies / 1e3
        rate = 2 * IB * IB * 4 / each_s / 1e12
        print(f"[mesh] {label}: device time {found['total']:.3f} ms, of it "
              f"the GEMMs {found[F32_KERNEL][0]:.3f} ms, the "
              f"{n_copies} ppermute copies {copy_ms:.3f} ms "
              f"({each_s * 1e6:.2f} us each, {rate:.3f} TB/s read + "
              f"written) and the fills {fill_ms:.3f} ms (the "
              f"zeroed staging and C); busy {busy:.1f}% of the warm wall "
              f"({card})")
    check(set(launches.values()) == {leaves},
          f"[mesh] GEMM launches by schedule {launches}")

    # -- the chain kernels under pallas="auto" on an armed rank mesh --------
    chain_launches = {}
    for label, (run, wrapper, levels) in chains.items():
        want, _ = run("serial")

        def mesh_run(run=run):
            return run(bind.MeshBackend(pallas="auto", devices=devices))

        def describe(phase, result, got, wall, mallocs, label=label,
                     wrapper=wrapper, levels=levels, want=want):
            res, mb = result
            print(f"[mesh] {label} {phase}: MeshBackend(pallas=\"auto\", "
                  f"{MESH_RANKS} ranks on {dev}): wall {wall * 1e3:.3f} ms, "
                  f"pallas_chains_dispatched {mb.pallas_chains_dispatched}, "
                  f"ops_pallas {mb.ops_pallas}, launches {got}")
            check(mb.pallas == "auto" and mb._pallas_enabled(),
                  f"{label}: pallas=\"auto\" not enabled")
            same_bits(f"mesh {label} {phase}: vs serial", res, want)
            check(mb.pallas_chains_dispatched == 1
                  and mb.ops_pallas == levels,
                  f"{label}: {mb.pallas_chains_dispatched} chain "
                  f"dispatches, {mb.ops_pallas} ops, expected 1 and "
                  f"{levels}")
            only(f"mesh {label}", got, wrapper, 1)
            if wrapper == "chain.dot":
                routes = dict(importlib.import_module(
                    "repro_torch.kernels.chain.ops").chain_dot.routes)
                check(routes == {F32_ROUTE: 1}, f"mesh {label}: chain_dot "
                      f"by route {routes}, expected {F32_ROUTE}")

        _kept, got, _walls = measured(f"mesh {label}", mesh_run, describe)
        chain_launches[wrapper] = got[wrapper]
        del want, describe      # the closure holds the serial result

    # -- distributed_gemm_shardmap on a (2, 4) rank mesh ---------------------
    dense = A @ B
    dense_ms = time_ms(torch, lambda: A @ B, iters=SHARDMAP_ITERS, warmup=1)
    dense_norm = torch.linalg.norm(dense.double()).item()
    mesh = make_mesh(SHARDMAP_MESH, ("p", "q"), (dev,) * math.prod(
        SHARDMAP_MESH))
    out["shardmap_ms"], out["dense_ms"] = {}, dense_ms
    for schedule in ("tree", "ring"):
        fn = distributed_gemm_shardmap(mesh, schedule=schedule)
        copies, nbytes = mesh.copies, mesh.bytes_copied
        C = fn(A, B)
        torch.cuda.synchronize()
        copies, nbytes = mesh.copies - copies, mesh.bytes_copied - nbytes
        check(C.shape == dense.shape and C.device == dense.device
              and bool(torch.isfinite(C).all()),
              f"[mesh] shardmap {schedule}: {C.dtype}{tuple(C.shape)}")
        rel = torch.linalg.norm(C.double() - dense.double()).item() \
            / dense_norm
        check(rel <= SHARDMAP_TOL, f"[mesh] shardmap {schedule}: relative "
              f"error {rel:.3e} > {SHARDMAP_TOL}")
        del C
        ms = time_ms(torch, lambda fn=fn: fn(A, B), iters=SHARDMAP_ITERS,
                     warmup=1)
        out["shardmap_ms"][schedule] = ms
        print(f"[mesh] distributed_gemm_shardmap {SHARDMAP_MESH} ranks on "
              f"{dev}, {n}^2 float32, schedule {schedule}: rel_err "
              f"{rel:.3e} against the dense product (<= {SHARDMAP_TOL}), "
              f"{copies} copies of {nbytes} bytes a call, {ms:.3f} ms a "
              f"call against the dense A @ B's {dense_ms:.3f} ms "
              f"({ms / dense_ms:.2f}x) ({card})")
    del dense

    # -- the three self-tests, their ranks sharing the card -----------------
    for name in ("collectives", "mesh", "distgemm"):
        module = importlib.import_module(
            f"repro_torch.launch.selftest_{name}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = module.main(["--device", "cuda"])
        torch.cuda.synchronize()
        lines = buf.getvalue().splitlines()
        check(rc == 0 and lines[-1:] == ["OK"],
              f"[mesh] selftest_{name} --device cuda: rc {rc}, {lines[-3:]}")
        print(f"[mesh] python -m repro_torch.launch.selftest_{name} --device "
              f"cuda: OK in {time.perf_counter() - t0:.2f} s")
    memory_back(torch, dev, base, "[mesh] the phase")
    return {"gemm.matmul": launches["tree"], **chain_launches, "mesh": out}


def bits(torch, t):
    """``t``'s bit pattern as integers (NaNs and signed zeros compare)."""
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(width[t.element_size()])


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import core as bind
    from repro_torch.kernels.chain import kernel as chain_kernel
    from repro_torch.kernels.chain import ops as chain_ops
    from repro_torch.kernels.chain import ref as chain_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_attention.ops import attn_step
    from repro_torch.kernels.gemm import kernel, ops, ref
    from repro_torch.kernels.gemm.ops import gemm_tile
    from repro_torch.kernels.linear_scan import kernel as ls_kernel
    from repro_torch.kernels.linear_scan import ops as ls_ops
    from repro_torch.kernels.linear_scan import ref as ls_ref
    from repro_torch.kernels.linear_scan import scan_step
    from repro_torch.linalg import Tiled, gemm_strassen
    from repro_torch.linalg import tiles as tiles_ops
    from repro_torch.linalg.distributed import run_distributed_gemm
    from repro_torch.mapreduce import sort_integers
    from repro_torch.serve import (RuntimeOverloaded, ServingRuntime,
                                   SessionPoisoned)

    # -- 1. environment ---------------------------------------------------------
    card = gpu_name_and_power()
    print(f"[env] nvidia-smi: {card}")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices "
          f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # -- 2. build: one nvcc per library, started together -------------------
    t0 = time.perf_counter()
    libraries = (kernel.LIBRARY, chain_kernel.LIBRARY, fa_kernel.LIBRARY,
                 ls_kernel.LIBRARY, fa_kernel.BWD_LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as pool:
        built = list(pool.map(lambda lib: lib.build(), libraries))
    for lib in libraries:
        lib.load()
    print(f"[build] {len(libraries)} libraries in "
          f"{time.perf_counter() - t0:.3f} s")
    for lib_path, log in built:
        print(f"[build] {lib_path.relative_to(ROOT)}")
        # one line per kernel: its registers and spills (chain_ewise's 81
        # per-layout kernels summed up in one line)
        ewise = []
        kernel_name = None
        for line in log.splitlines():
            if "error" in line.lower():
                print(f"[build]   {line.strip()}")
            # ptxas serialised the wgmma of an attention tensor-core kernel
            # (chain_attn's among them) for registers (C7511) or around a
            # call (C7514)
            if ("C7511" in line or "C7514" in line) and (
                    "attention" in line or "chain_attn_" in line):
                print(f"[build]   {line.strip()[:240]}")
                check(False, f"wgmma serialised: {line.strip()[:240]}")
            if "Function properties for" in line:
                kernel_name = line.split("for")[-1].strip()
                spill = ""
            elif "spill stores" in line and kernel_name:
                spill = line.strip()
            elif "registers" in line and kernel_name:
                regs = line.split("Used")[1].split(",")[0].strip()
                # the tensor-core attention kernels hold their
                # accumulators in registers, and must not spill them (the
                # backward's of every dtype, the 16-bit forward of bf16
                # and f16, and the 3xTF32 forward)
                # (and the GEMM's, chain_dot's and chain_attn's: 3xTF32,
                # and wgmma in bf16 and f16)
                check(not (("attention_bwd" in kernel_name
                            and ("wgmma" in kernel_name
                                 or "tf32" in kernel_name))
                           or "flash_attention_wgmma" in kernel_name
                           or "flash_attention_tf32" in kernel_name
                           or "gemm_tf32_kernel" in kernel_name
                           or "chain_dot_tf32_kernel" in kernel_name
                           or "gemm_wgmma_kernel" in kernel_name
                           or "chain_dot_wgmma_kernel" in kernel_name
                           or "chain_attn_wgmma_kernel" in kernel_name
                           or "chain_attn_tf32_kernel" in kernel_name)
                      or spill.startswith("0 bytes stack frame, 0 bytes "
                                          "spill stores"),
                      f"{kernel_name}: spills ({spill})")
                if "chain_ewise_kernel" in kernel_name:
                    ewise.append((regs, spill))
                else:
                    print(f"[build]   {kernel_name[:110]}: {regs}, {spill}")
                kernel_name = None
        if ewise:
            regs = sorted(int(r.split()[0]) for r, _ in ewise)
            spilled = sum(not sp.startswith("0 bytes stack") for _, sp in ewise)
            print(f"[build]   chain_ewise_kernel: {len(ewise)} per-layout "
                  f"kernels, {regs[0]}-{regs[-1]} registers, {spilled} with "
                  f"a stack frame or spills")

    def half_forms(name, functions, prefix):
        """The operand type of each 16-bit instantiation's HGMMA (the
        functions whose mangled name starts with ``prefix`` and holds the
        element type): bf16 ones name it (HGMMA.64x64x16.F32.BF16), f16
        ones do not (HGMMA.64x64x16.F32, the f16 form), and none is
        TF32."""
        for key, mangled in HALF_MANGLED.items():
            kinds = {line.split("HGMMA")[1].split()[0]
                     for f in functions
                     if prefix in f.split("\n", 1)[0]
                     and (mangled in f.split("\n", 1)[0] if "ILi" in prefix
                          else f"{prefix}{mangled}" in f.split("\n", 1)[0])
                     for line in f.splitlines() if "HGMMA" in line}
            want = ".F32.BF16" if key == "bf16" else ".F32"
            print(f"[build]   {name} {key} HGMMA forms: {sorted(kinds)}")
            check(bool(kinds) and all(x.endswith(want) for x in kinds),
                  f"{name} {key}: HGMMA forms {sorted(kinds)}, each "
                  f"expected to end in {want}")

    # the tensor-core routes really issue tensor-core instructions: wgmma
    # is HGMMA in the SASS (on TF32 operands for the 3xTF32 GEMM), the f64
    # MMA DMMA
    cuobjdump = Path(kernel.nvcc()).parent / "cuobjdump"
    for lib_path, wants in ((built[0][0], {"gemm_wgmma_kernel": "HGMMA",
                                           "gemm_dmma_kernel": "DMMA",
                                           "gemm_tf32_kernel": TF32_HGMMA}),
                            (built[1][0], {"chain_dot_wgmma_kernel": "HGMMA",
                                           "chain_dot_dmma_kernel": "DMMA",
                                           "chain_dot_tf32_kernel":
                                           TF32_HGMMA,
                                           "chain_attn_wgmma_kernel": "HGMMA",
                                           "chain_attn_tf32_kernel":
                                           "HGMMA"}),
                            (built[2][0], {"flash_attention_wgmma_kernel":
                                           "HGMMA",
                                           "flash_attention_tf32_kernel":
                                           "HGMMA"}),
                            (built[4][0], {"attention_bwd_dq_wgmma_kernel":
                                           "HGMMA",
                                           "attention_bwd_dkv_wgmma_kernel":
                                           "HGMMA",
                                           "attention_bwd_dq_tf32_kernel":
                                           "HGMMA",
                                           "attention_bwd_dkv_tf32_kernel":
                                           "HGMMA"})):
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        functions = sass.split("Function : ")[1:]
        for name, op in wants.items():
            body = "".join(f for f in functions
                           if f.split("\n", 1)[0].find(name) >= 0)
            count = body.count(op)
            print(f"[build] {name}: {count} {op} instructions in its SASS")
            check(count > 0, f"{name}: no {op} instruction in its SASS")
            if name in ("gemm_wgmma_kernel", "chain_dot_wgmma_kernel",
                        "chain_attn_wgmma_kernel"):
                # the 16-bit GEMM loop's and chain_attn's bf16 and f16
                # instantiations (the element type, the first template
                # argument)
                half_forms(name, functions, f"{name}I")
            if name.startswith("chain_attn_"):
                # each head dim's instantiation: HGMMA on its operand type
                # (.F32.TF32 in 3xTF32, .F32.BF16 / .F32 in bf16 / f16)
                if "tf32" in name:
                    tags = {f"{d}": (f"{name}ILi{d}E", ".F32.TF32")
                            for d in chain_ops.TF32_HEAD_DIMS}
                else:
                    tags = {f"{d} {key}": (f"{name}I{mangled}Li{d}E",
                                           ".F32.BF16" if key == "bf16"
                                           else ".F32")
                            for d in fa_ops.WGMMA_HEAD_DIMS
                            for key, mangled in HALF_MANGLED.items()}
                per_d = {}
                for tag, (mangled, form) in tags.items():
                    forms = [line.split("HGMMA")[1].split()[0]
                             for f in functions
                             if mangled in f.split("\n", 1)[0]
                             for line in f.splitlines() if "HGMMA" in line]
                    per_d[tag] = len(forms)
                    check(bool(forms) and all(x.endswith(form)
                                              for x in forms),
                          f"{name} {tag}: HGMMA forms {sorted(set(forms))},"
                          f" each expected to end in {form}")
                print(f"[build]   HGMMA by instantiation: {per_d}")
            if "attention" not in name or op != "HGMMA":
                continue
            # each head dim's instantiation of the attention tensor-core
            # kernels, those whose last panel is partly real among them
            # (the 16-bit kernels' bf16 and f16 ones apart, by their
            # mangled element type; the 3xTF32 forward's with and without
            # its log-sum-exp apart, and the 3xTF32 dk/dv kernel's dV and
            # dK sweeps)
            if "tf32" not in name:
                tags = {f"{d} {key}": f"{name}ILi{d}E{mangled}"
                        for d in fa_ops.WGMMA_HEAD_DIMS
                        for key, mangled in HALF_MANGLED.items()}
            elif "dq" in name:
                tags = {d: f"{name}ILi{d}E" for d in fa_ops.TF32_HEAD_DIMS}
            else:
                what = ("", "+lse") if "bwd" not in name else (" dv", " dk")
                tags = {f"{d}{what[x]}": f"{name}ILi{d}ELb{x}E"
                        for d in fa_ops.TF32_HEAD_DIMS for x in (0, 1)}
            per_d = {d: sum(f.count(op) for f in functions
                            if tag in f.split("\n", 1)[0])
                     for d, tag in tags.items()}
            print(f"[build]   {op} by head dim: {per_d}")
            check(all(per_d.values()), f"{name}: an instantiation without "
                  f"{op} in its SASS ({per_d})")
            if "tf32" in name:
                continue
            half_forms(name, functions, f"{name}ILi")

    # each section's seconds, as [time] lines: the time since the last lap
    last_lap = [time.perf_counter()]

    def lap(label=None):
        now = time.perf_counter()
        if label:
            print(f"[time] {label}: {now - last_lap[0]:.1f} s")
        last_lap[0] = now

    print(f"[time] [build] and SASS: {time.perf_counter() - T_START:.1f} s "
          f"since the start")

    # -- 3. GEMM kernel against its plain version ----------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def uniform(shape, dtype, bound=0.95):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * bound).to(dtype)

    def close(tag, name, got, exp, rtol, atol):
        """Check ``got`` against ``exp``; returns the largest error."""
        torch.cuda.synchronize()
        check(got.dtype == exp.dtype and got.shape == exp.shape,
              f"{name}: {got.dtype}{tuple(got.shape)} != "
              f"{exp.dtype}{tuple(exp.shape)}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
        torch.testing.assert_close(got, exp, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{name}: {m}")
        err = (got.double() - exp.double()).abs().max().item() \
            if got.numel() else 0.0
        print(f"[{tag}] {name}: max_abs_err {err:.3e} within rtol {rtol} "
              f"atol {atol}: ok")
        return err

    def compare(name, got, exp, dtype_name):
        return close("gemm", name, got, exp, *TOL[dtype_name])

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float64": torch.float64}

    def gemm_route(a, b, a_stride=0, b_stride=0, addresses=None):
        """The route ops.route gives these operands, checked against the
        one the built library's launcher takes."""
        m, k = a.shape[-2:]
        n = b.shape[-1]
        want = ops.route(a.dtype, m, n, k, addresses if addresses is not None
                         else (a.data_ptr(), b.data_ptr()))
        got = ops.ROUTES[kernel.launcher_route(
            a.dtype, a.data_ptr(), a_stride, b.data_ptr(), b_stride, m, n, k)]
        check(got == want, f"GEMM route: the launcher takes {got}, "
              f"ops.route says {want}")
        return want

    # the tensor-core route each type is held on against float64, beside
    # the CUDA-core route that copies one element into their storage take
    vs_routes = {torch.float32: (F32_ROUTE, "f32_simt"),
                 torch.float16: ("f16_wgmma", "f16_simt")}

    def vs_simt(name, call, route, exact, a, b, limit=TF32_VS_SIMT,
                tag="gemm"):
        """``call(a, b)`` of float32 (float16) ``a``, ``b`` on
        ``f32_3xtf32`` (``f16_wgmma``; the route ``route(a, b)`` names),
        against ``exact`` (float64) beside ``f32_simt``'s (``f16_simt``'s)
        error on the same values (``call`` of copies one element into their
        storage, which 16-byte loads cannot read): at most ``limit`` times
        it (printed only when ``limit`` is None); two calls bit for bit.
        Returns the output, both errors and the odd-offset copies."""
        tc, simt_route = vs_routes[a.dtype]
        check(route(a, b) == tc, f"{name}: takes {route(a, b)}, expected "
              f"{tc}")
        got = call(a, b)
        again = call(a, b)
        odd = (odd_offset(a), odd_offset(b))
        check(route(*odd) == simt_route,
              f"{name}: the odd-offset copies take {route(*odd)}")
        simt = call(*odd)
        torch.cuda.synchronize()
        check(torch.equal(bits(torch, got), bits(torch, again)),
              f"{name}: two calls differ")
        err = (got.double() - exact).abs().max().item()
        base = (simt.double() - exact).abs().max().item()
        check(limit is None or err <= limit * base, f"{name}: against "
              f"float64 {err:.3e}, {err / max(base, 1e-30):.2f} x "
              f"{simt_route}'s {base:.3e} (limit {limit})")
        held = f"limit {limit}" if limit else "not held: K 4"
        print(f"[{tag}]   {name} against float64: {err:.3e}, {simt_route} "
              f"{base:.3e} on the same values ({err / max(base, 1e-30):.2f}"
              f" x, {held}); two calls bit for bit")
        return got, err, base, odd

    def gemm_f32(fn, a, b, c=None):
        """``fn`` (``ops.matmul`` or ``ops.matmul_accumulate``) as the
        ``call``, ``route`` and ``exact`` of vs_simt and simt_numbers."""
        exact = a.double() @ b.double()
        if c is not None:
            exact += c.double()
        lead = () if c is None else (c,)
        return (lambda x, y: fn(*lead, x, y)), gemm_route, exact

    def simt_numbers(name, call, route, exact, a, b, ms, flops, nbytes,
                     tag="gemm", iters=20, limit=TF32_VS_SIMT, timer=time_ms):
        """The tensor-core leaf's extra numbers: float64 errors of both
        routes (vs_simt), the CUDA-core route's time on the same values
        (must be above the kernel's) and bound at 67 TFLOP/s (its
        arithmetic is float32 FMAs in float16 too); in float32 the route's
        own bound at three TF32 products.  The kernel (first timed as
        ``ms``) and the CUDA-core route are timed by ``timer`` in the order
        kernel, CUDA cores, CUDA cores, kernel and each keeps its better
        time: the card's first timings of the script read up to 3x
        slow."""
        _got, err, base, odd = vs_simt(name, call, route, exact, a, b,
                                       limit, tag)
        tc, simt_route = vs_routes[a.dtype]
        simt_ms = min(timer(torch, lambda: call(*odd), iters)
                      for _ in range(2))
        ms = min(ms, timer(torch, lambda: call(a, b), iters))
        simt_bnd, _ = bound_ms(nbytes, flops, "float32")
        check(ms < simt_ms, f"{name}: {tc} {ms:.4f} ms is not below "
              f"{simt_route}'s {simt_ms:.4f} on the same values")
        out = dict(ms=ms, simt_ms=simt_ms, simt_bound_ms=simt_bnd,
                   err64=err, simt_err64=base,
                   vs_simt=err / max(base, 1e-30))
        own = ""
        if a.dtype == torch.float32:
            bnd, by = bound_ms(nbytes, TF32_PRODUCTS * flops, "tf32")
            out.update(bound_ms=bnd, bound_by=by)
            own = (f"; {tc}'s bound {bnd:.4f} ms at three TF32 products "
                   f"({bnd / ms:.3f} of it)")
        print(f"[{tag}]   {name}: {simt_route} on the same values "
              f"{simt_ms:.4f} ms (bound {simt_bnd:.4f} ms at 67 TFLOP/s), "
              f"{tc} {ms:.4f} ms, {simt_ms / ms:.2f}x faster{own}")
        return out

    leaf = {}
    for dname, dt in dtypes.items():
        a, b = rand((IB, IB), dt), rand((IB, IB), dt)
        path = gemm_route(a, b)
        err = compare(f"matmul {IB}^3 {dname} [{path}]", ops.matmul(a, b),
                      ref.matmul(a, b), dname)
        ms = time_ms(torch, lambda: ops.matmul(a, b))
        plain = time_ms(torch, lambda: ref.matmul(a, b))
        lib = time_ms(torch, lambda: torch.matmul(a, b))
        flops = 2 * IB ** 3
        nbytes = 3 * IB * IB * a.element_size()
        bnd, by = bound_ms(nbytes, flops, dname)
        extra = (simt_numbers(f"matmul {IB}^3 float32",
                             *gemm_f32(ops.matmul, a, b), a, b, ms, flops,
                             nbytes)
                 if dt == torch.float32 else {})
        ms = extra.pop("ms", ms)
        bnd, by = extra.get("bound_ms", bnd), extra.get("bound_by", by)
        print(f"[gemm] matmul {IB}^3 {dname} [{path}]: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms, "
              f"torch.matmul {lib:.4f} ms, bound {bnd:.4f} ms ({by})")
        leaf[("matmul", dname)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                       library_ms=lib, gemm_route=path,
                                       **{"bound_ms": bnd, "bound_by": by,
                                          **extra})
    for dname, dt in dtypes.items():
        c, a, b = rand((IB, IB), dt), rand((IB, IB), dt), rand((IB, IB), dt)
        path = gemm_route(a, b)
        err = compare(f"matmul_accumulate {IB}^3 {dname} [{path}]",
                      ops.matmul_accumulate(c, a, b),
                      ref.matmul_accumulate(c, a, b), dname)
        ms = time_ms(torch, lambda: ops.matmul_accumulate(c, a, b))
        plain = time_ms(torch, lambda: ref.matmul_accumulate(c, a, b))
        lib = time_ms(torch, lambda: torch.addmm(c, a, b))
        flops = 2 * IB ** 3 + IB * IB
        nbytes = 4 * IB * IB * a.element_size()
        bnd, by = bound_ms(nbytes, flops, dname)
        extra = (simt_numbers(f"matmul_accumulate {IB}^3 float32",
                             *gemm_f32(ops.matmul_accumulate, a, b, c), a,
                             b, ms, flops, nbytes)
                 if dt == torch.float32 else {})
        ms = extra.pop("ms", ms)
        bnd, by = extra.get("bound_ms", bnd), extra.get("bound_by", by)
        print(f"[gemm] matmul_accumulate {IB}^3 {dname} [{path}]: kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain "
              f"{plain:.4f} ms, torch.addmm {lib:.4f} ms, bound {bnd:.4f} ms "
              f"({by})")
        leaf[("matmul_accumulate", dname)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            gemm_route=path, **{"bound_ms": bnd, "bound_by": by, **extra})
    # f32_3xtf32 against float64 beyond the leaf: K 8192 (a chain_dot's
    # eight levels in one sum), aligned ragged M and N, a last k8 step of
    # 4 (K % 8 == 4), a single row; inputs from a generator of their own,
    # so every later check draws what it drew before
    tf32_gen = torch.Generator(device=dev)
    tf32_gen.manual_seed(SEED)
    for m, k, n in TF32_SHAPES + TF32_TINY:
        a = torch.randn((m, k), generator=tf32_gen, device=dev)
        b = torch.randn((k, n), generator=tf32_gen, device=dev)
        c = torch.randn((m, n), generator=tf32_gen, device=dev)
        for name, fn, cc in (("matmul", ops.matmul, None),
                             ("matmul_accumulate", ops.matmul_accumulate, c)):
            label = f"{name} ({m},{k},{n}) float32 [{F32_ROUTE}]"
            got, _err, _base, _odd = vs_simt(
                label, *gemm_f32(fn, a, b, cc), a, b,
                limit=None if (m, k, n) in TF32_TINY else TF32_VS_SIMT)
            compare(label, got, ref.matmul(a, b) if cc is None
                    else ref.matmul_accumulate(cc, a, b), "float32")
        del a, b, c
    # non-finite inputs: NaNs (CUDA's canonical 0x7FFFFFFF, its negative,
    # torch's 0x7FC00000 and its negative) and infinities of both signs in
    # a and b, two infinities in one row, -inf meeting a zero.
    # f32_3xtf32 (and f32_simt on odd-offset copies) must give NaN, +inf
    # and -inf exactly where torch.matmul's IEEE product (torch.addmm's)
    # has them
    a = torch.randn((IB, IB), generator=tf32_gen, device=dev)
    b = torch.randn((IB, IB), generator=tf32_gen, device=dev)
    c = torch.randn((IB, IB), generator=tf32_gen, device=dev)
    for x, at, word in NON_FINITE:
        (a if x == "a" else b).view(torch.int32)[at] = word
    b[40, 11] = 0.0

    def non_finite(x):
        return torch.isnan(x), torch.isposinf(x), torch.isneginf(x)

    for name, fn, cc, lib in (
            ("matmul", ops.matmul, None, torch.matmul(a, b)),
            ("matmul_accumulate", ops.matmul_accumulate, c,
             torch.addmm(c, a, b))):
        lead = () if cc is None else (cc,)
        check(gemm_route(a, b) == F32_ROUTE, f"{name} with NaN and inf: "
              f"takes {gemm_route(a, b)}")
        want = non_finite(lib)
        counts = [int(w.sum()) for w in want]
        check(all(counts), f"{name} with NaN and inf: torch's NaN, +inf, "
              f"-inf counts {counts}")
        for route_name, got in (
                (F32_ROUTE, fn(*lead, a, b)),
                ("f32_simt", fn(*lead, odd_offset(a), odd_offset(b)))):
            have = non_finite(got)
            check(all(torch.equal(h, w) for h, w in zip(have, want)),
                  f"{name} {IB}^3 float32 [{route_name}] with NaN and inf "
                  f"inputs: NaN, +inf, -inf counts "
                  f"{[int(h.sum()) for h in have]} not where torch's "
                  f"{counts} are")
        print(f"[gemm] {name} {IB}^3 float32 with NaN and inf inputs: NaN, "
              f"+inf, -inf outputs {counts} on {F32_ROUTE} and f32_simt, "
              f"exactly where torch's are")
    del a, b, c, lib
    # the ragged edge on every route; (130, 72, 264) is ragged but TMA can
    # read it in bfloat16 (the tensor-core route), the others are not
    for m, k, n in ((130, 70, 260), (1, 128, 1), (130, 72, 264)):
        for dname, dt in dtypes.items():
            a, b, c = rand((m, k), dt), rand((k, n), dt), rand((m, n), dt)
            path = gemm_route(a, b)
            compare(f"matmul ({m},{k},{n}) {dname} [{path}]",
                    ops.matmul(a, b), ref.matmul(a, b), dname)
            compare(f"matmul_accumulate ({m},{k},{n}) {dname} [{path}]",
                    ops.matmul_accumulate(c, a, b),
                    ref.matmul_accumulate(c, a, b), dname)
    # float16 on both routes (fp32 inside, one rounding; (130, 72, 264) on
    # f16_wgmma, the others on f16_simt): the plain version sums in another
    # order, so an output may round one fp16 ulp (2^-10 relative) apart;
    # TOL["float16"] is ten of those
    for m, k, n in ((130, 70, 260), (1, 128, 1), (130, 72, 264)):
        a = rand((m, k), torch.float16)
        b = rand((k, n), torch.float16)
        c = rand((m, n), torch.float16)
        path = gemm_route(a, b)
        compare(f"matmul ({m},{k},{n}) float16 [{path}]", ops.matmul(a, b),
                ref.matmul(a, b), "float16")
        compare(f"matmul_accumulate ({m},{k},{n}) float16 [{path}]",
                ops.matmul_accumulate(c, a, b),
                ref.matmul_accumulate(c, a, b), "float16")
    # out_dtype: the accumulator written in another type, rounded once; the
    # output type does not choose the route.  Every output type of every
    # input type on the ragged shapes and the odd-offset views:
    # - held to ref.matmul(out_dtype=) within out_tolerance: the less
    #   precise of the accumulator's and the output type's TOL, so a wide
    #   output of narrow inputs is held at float32's (the sums run in
    #   another order, and one rounding may land an ulp of the output apart);
    # - bit for bit the accumulator written in its own type (float32, or
    #   float64 for float64 inputs) and rounded once to the output type,
    #   by torch's cast, or for float64 -> bfloat16 / float16 (which torch
    #   rounds twice) by nearest_even: every epilogue is one rounding of the
    #   same sum;
    # - the input's own type as output is the default's bits, a bfloat16 /
    #   float16 product written as float32 and rounded back is that type's
    #   own output bit for bit, and is not that output widened.
    # Its inputs come from a generator of their own, so the draws of every
    # check after it are the ones they were before it came
    every = {**dtypes, "float16": torch.float16}
    out_gen = torch.Generator(device=dev)
    out_gen.manual_seed(SEED)

    def out_rand(shape, dtype):
        return torch.randn(shape, generator=out_gen, device=dev).to(dtype)

    def epilogue(name, got, wide, path):
        want = nearest_even(torch, wide, got.dtype)
        torch.cuda.synchronize()
        if not torch.equal(bits(torch, got), bits(torch, want)):
            i = int((bits(torch, got) != bits(torch, want)).flatten()
                    .nonzero()[0])
            fail(f"{name} [{path}]: element {i} is "
                 f"{got.flatten()[i].item()!r}, the {wide.dtype} sum rounded "
                 f"once {want.flatten()[i].item()!r}")

    for din, dt in every.items():
        acc = "float64" if din == "float64" else "float32"
        for shape in ((130, 70, 260), (1, 128, 1), (130, 72, 264), "odd"):
            if shape == "odd":
                m = k = n = IB
                a = out_rand((IB * IB + 1,), dt)[1:].view(IB, IB)
                b = out_rand((IB * IB + 1,), dt)[1:].view(IB, IB)
            else:
                m, k, n = shape
                a, b = out_rand((m, k), dt), out_rand((k, n), dt)
            path = gemm_route(a, b)
            own = ops.matmul(a, b)
            wide = ops.matmul(a, b, out_dtype=every[acc])
            for dout, ot in every.items():
                got = ops.matmul(a, b, out_dtype=ot)
                close("gemm", f"matmul {shape} {din} -> {dout} [{path}]",
                      got, ref.matmul(a, b, ot), *out_tolerance(din, dout))
                epilogue(f"matmul {shape} {din} -> {dout}", got, wide, path)
                if dout == din:
                    torch.cuda.synchronize()
                    check(torch.equal(got, own), f"matmul {shape} {din}: "
                          f"out_dtype={din} differs from the default")
            print(f"[gemm] matmul {shape} {din} -> every type: the {acc} "
                  f"sum rounded once, bit for bit [{path}]")
            if din in ("bfloat16", "float16"):
                back = wide.to(dt)
                torch.cuda.synchronize()
                if not torch.equal(back, own):
                    i, j = (back != own).nonzero()[0].tolist()
                    fail(f"matmul {shape} {din} -> float32 -> {din}: "
                         f"element ({i}, {j}) is {back[i, j].item()!r}, "
                         f"the {din} output's {own[i, j].item()!r}")
                check(own.numel() == 1 or not torch.equal(wide, own.float()),
                      f"matmul {shape} {din} -> float32: every element is "
                      f"the {din} output widened")
                print(f"[gemm] matmul {shape} {din} -> float32 rounded to "
                      f"{din}: bit for bit the {din} output, and not that "
                      f"output widened [{path}]")
    # float64 sums just past a tie of bfloat16 / float16 (rows of one
    # element against a first row of B of ones: exact sums), where a
    # rounding through float32 lands on the other side
    ties = [1 + 2.0 ** -8 + 2.0 ** -30, -(3 + 2.0 ** -7 + 2.0 ** -31),
            1 + 2.0 ** -11 + 2.0 ** -40, -(5 + 2.0 ** -9 + 2.0 ** -35)]
    a = out_rand((64, 72), torch.float64)
    b = out_rand((72, 64), torch.float64)
    b[0] = 1.0
    a[:len(ties)] = 0.0
    a[:len(ties), 0] = torch.tensor(ties, dtype=torch.float64, device=dev)
    path = gemm_route(a, b)
    wide = ops.matmul(a, b)
    for ot in (torch.bfloat16, torch.float16):
        got = ops.matmul(a, b, out_dtype=ot)
        epilogue(f"matmul ties float64 -> {ot}", got, wide, path)
        torch.cuda.synchronize()
        twice = wide[:len(ties)].to(ot)
        check(not torch.equal(twice, got[:len(ties)]),
              f"matmul ties float64 -> {ot}: no tie where torch's cast "
              f"rounds twice")
        print(f"[gemm] matmul ties float64 -> {ot} [{path}]: the float64 sums "
              f"rounded once, where torch's cast through float32 gives "
              f"{int((twice != got[:len(ties)]).any(1).sum())} of "
              f"{len(ties)} other values")
    # at 1024^3: bfloat16 (bf16_wgmma) and float16 (f16_wgmma) written as
    # float32, beside the same inputs' own output and each one's bound;
    # the kernel and the library call timed from a CUDA graph (the
    # wrapper's host time per call is above the tensor-core kernels' time).
    # float16 also on f16_simt, on copies of the same values one element
    # into their storage: f16_wgmma must beat it, give the same bits on
    # two calls and stay within F16_VS_SIMT of its float64 error
    for din in ("bfloat16", "float16"):
        dt = every[din]
        a, b = out_rand((IB, IB), dt), out_rand((IB, IB), dt)
        path = gemm_route(a, b)
        flops = 2 * IB ** 3
        times = {}
        for dout in (din, "float32"):
            ot = every[dout]
            got = ops.matmul(a, b, out_dtype=ot)
            err = close("gemm", f"matmul {IB}^3 {din} -> {dout} [{path}]",
                        got, ref.matmul(a, b, ot), *out_tolerance(din, dout))
            if dout == "float32":
                own = ops.matmul(a, b)
                torch.cuda.synchronize()
                check(torch.equal(got.to(dt), own)
                      and not torch.equal(got, own.float()),
                      f"matmul {IB}^3 {din} -> float32: not the {din} output "
                      f"once rounded back, or that output widened")
            ms = graph_ms(torch, lambda: ops.matmul(a, b, out_dtype=ot))
            plain = time_ms(torch, lambda: ref.matmul(a, b, ot))
            bnd, by = bound_ms(2 * IB * IB * a.element_size()
                               + IB * IB * ot.itemsize, flops, din)
            try:
                lib = graph_ms(torch, lambda: torch.mm(a, b, out_dtype=ot))
                lib_says = f"torch.mm(out_dtype) {lib:.4f} ms"
            except (TypeError, RuntimeError) as exc:
                lib = None if dout != din else graph_ms(
                    torch, lambda: torch.mm(a, b))
                lib_says = (f"torch.mm {lib:.4f} ms" if lib is not None
                            else f"torch.mm(out_dtype) missing ({exc!r})")
            times[dout] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                               bound_ms=bnd, bound_by=by, library_ms=lib,
                               gemm_route=path)
            if dout == din:
                # torch.matmul in the input's own dtype: the yardstick of
                # a tensor-core route for it
                times[dout]["matmul_ms"] = graph_ms(
                    torch, lambda: torch.matmul(a, b))
                lib_says += (f", torch.matmul "
                             f"{times[dout]['matmul_ms']:.4f} ms")
            if din == "float16":
                times[dout].update(simt_numbers(
                    f"matmul {IB}^3 float16 -> {dout}",
                    lambda x, y, ot=ot: ops.matmul(x, y, out_dtype=ot),
                    gemm_route, a.double() @ b.double(), a, b, ms, flops,
                    2 * IB * IB * 2 + IB * IB * ot.itemsize,
                    limit=F16_VS_SIMT[dout], timer=graph_ms))
                ms = times[dout]["ms"]
            print(f"[gemm] matmul {IB}^3 {din} -> {dout} [{path}]: kernel "
                  f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain "
                  f"{plain:.4f} ms, {lib_says}, bound {bnd:.4f} ms ({by})")
        leaf[("matmul", f"{din}->float32")] = times["float32"]
        leaf[("matmul", f"{din}->{din}")] = times[din]
    # float16 at the edges of its range, on both routes (f16_simt on copies
    # one element in), from a generator of its own:
    # - past 65504: integers in [-64, 64] (exact in float16; their products
    #   and any sum of 1024 of them exact in float32, so every route's
    #   accumulator holds the exact sum whatever its order): the float16
    #   output bit for bit the plain version's, inf exactly where its is,
    #   the float32 output the exact sums;
    # - subnormal: a of magnitude 2^-20 (every nonzero element an f16
    #   subnormal), b unit normal, outputs near 2^-15 (subnormal too):
    #   within TOL["float16"] relative and two subnormal steps (2^-24) of
    #   the plain version, float32 outputs within float32's TOL at that
    #   scale: the tensor cores read and write subnormals, none flushed
    f16_gen = torch.Generator(device=dev)
    f16_gen.manual_seed(SEED)
    h16 = torch.float16

    def both_routes(a, b):
        odd = (odd_offset(a), odd_offset(b))
        for want, (x, y) in (("f16_wgmma", (a, b)), ("f16_simt", odd)):
            check(gemm_route(x, y) == want, f"float16 edge case: operands "
                  f"take {gemm_route(x, y)}, expected {want}")
            yield want, x, y

    a, b = (torch.randint(-64, 65, (IB, IB), generator=f16_gen,
                          device=dev).to(h16) for _ in range(2))
    exact = (a.double() @ b.double()).float()
    want = ref.matmul(a, b)
    n_inf = int(torch.isinf(want).sum())
    check(0 < n_inf < want.numel() // 2, f"float16 past 65504: {n_inf} "
          f"infinite outputs of the plain version")
    for path, x, y in both_routes(a, b):
        got = ops.matmul(x, y)
        wide = ops.matmul(x, y, out_dtype=torch.float32)
        torch.cuda.synchronize()
        check(torch.equal(bits(torch, got), bits(torch, want)),
              f"matmul {IB}^3 float16 past 65504 [{path}]: "
              f"{int((bits(torch, got) != bits(torch, want)).sum())} "
              f"outputs not the plain version's bits "
              f"({int(torch.isinf(got).sum())} infinite, the plain version "
              f"{n_inf})")
        check(torch.equal(wide, exact), f"matmul {IB}^3 float16 -> float32 "
              f"on exact sums [{path}]: not the exact sums")
        print(f"[gemm] matmul {IB}^3 float16 past 65504 [{path}]: bit for "
              f"bit the plain version, {n_inf} outputs inf exactly where its "
              f"are; as float32 the exact sums")
    a = (torch.randn((IB, IB), generator=f16_gen, device=dev)
         * 2.0 ** -20).to(h16)
    b = torch.randn((IB, IB), generator=f16_gen, device=dev).to(h16)
    nonzero = a != 0
    check(bool((a[nonzero].abs() < 2.0 ** -14).all())
          and int(nonzero.sum()) > a.numel() // 2,
          "float16 subnormal case: a is not subnormal")
    plain16, plain32 = ref.matmul(a, b), ref.matmul(a, b, torch.float32)
    sub = int(((plain16 != 0) & (plain16.abs() < 2.0 ** -14)).sum())
    for path, x, y in both_routes(a, b):
        close("gemm", f"matmul {IB}^3 float16 subnormal [{path}]",
              ops.matmul(x, y), plain16, TOL["float16"][0], 2 * 2.0 ** -24)
        close("gemm", f"matmul {IB}^3 float16 subnormal -> float32 [{path}]",
              ops.matmul(x, y, out_dtype=torch.float32), plain32,
              TOL["float32"][0], TOL["float32"][1] * 2.0 ** -14)
    print(f"[gemm] matmul {IB}^3 float16 on subnormal a ({int(nonzero.sum())} "
          f"nonzero), {sub} subnormal outputs: both routes within the "
          f"plain version's tolerance at that scale")
    del a, b, exact, want, got, wide, plain16, plain32
    # contiguous views one element into their storage: TMA cannot read them
    for dname, dt in dtypes.items():
        a = rand((IB * IB + 1,), dt)[1:].view(IB, IB)
        b = rand((IB * IB + 1,), dt)[1:].view(IB, IB)
        c = rand((IB, IB), dt)
        path = gemm_route(a, b)
        compare(f"matmul {IB}^3 {dname}, views at an odd offset [{path}]",
                ops.matmul(a, b), ref.matmul(a, b), dname)
        compare(f"matmul_accumulate {IB}^3 {dname}, views at an odd offset "
                f"[{path}]", ops.matmul_accumulate(c, a, b),
                ref.matmul_accumulate(c, a, b), dname)
    del a, b, c
    gemm_routes_run = {name: dict(fn.routes) for name, fn in
                       (("matmul", ops.matmul),
                        ("matmul_accumulate", ops.matmul_accumulate))}
    print(f"[gemm] launches by route: {gemm_routes_run}")
    for name, by_route in gemm_routes_run.items():
        check(set(by_route) == set(ops.ROUTES), f"{name}: routes run "
              f"{sorted(by_route)}, expected every one of {ops.ROUTES}")

    # the wrappers' host time per call, at a size where the card waits on
    # the host: what a host-bound workflow pays per GEMM launch
    def host_us(fn, calls=2000):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        elapsed = time.perf_counter() - t0
        torch.cuda.synchronize()
        return elapsed / calls * 1e6

    for dname in ("float32", "bfloat16"):
        a, b = rand((64, 64), dtypes[dname]), rand((64, 64), dtypes[dname])
        print(f"[gemm] host time per call at 64^3 {dname}: matmul "
              f"{host_us(lambda: ops.matmul(a, b)):.2f} us, torch.matmul "
              f"{host_us(lambda: torch.matmul(a, b)):.2f} us")
    del a, b

    lap("[gemm]")

    # -- 4. chain kernels against their plain versions -----------------------
    def same_bits(name, got, exp):
        torch.cuda.synchronize()
        check(got.dtype == exp.dtype and got.shape == exp.shape,
              f"{name}: {got.dtype}{tuple(got.shape)} != "
              f"{exp.dtype}{tuple(exp.shape)}")
        check(bool(torch.isfinite(exp).all()), f"{name}: non-finite values")
        differ = int((bits(torch, got) != bits(torch, exp)).sum().item())
        check(differ == 0, f"{name}: {differ} elements differ")

    kinds = ("single", "xs", "const", "xs_const")

    def ewise_layouts():
        # every layout chain/ops.py takes: the carry at each position, the
        # other two in every kind (y and a not both constants)
        for carry_pos in range(3):
            for k1 in kinds:
                for k2 in kinds:
                    layout = [k1, k2]
                    layout.insert(carry_pos, "single")
                    if layout[0] == layout[1] == "const":
                        continue
                    yield tuple(layout), carry_pos

    def ewise_args(layout, carry_pos, shape, L, dt):
        # y and a bounded (|.| < 0.95) so that 64 levels stay finite, x
        # unit normal; constants not exact in binary (they round)
        out = []
        for pos, lay in enumerate(layout):
            small = pos < 2
            if pos == carry_pos or lay == "single":
                out.append(uniform(shape, dt) if small else rand(shape, dt))
            elif lay == "xs":
                out.append(uniform((L,) + shape, dt) if small
                           else rand((L,) + shape, dt))
            elif lay == "const":
                out.append((0.1, -0.3, 0.7)[pos])
            else:
                out.append(torch.linspace(-0.9, 0.9, L, device=dev).to(dt))
        return tuple(out)

    n_ewise = 0
    for dname, dt in every.items():
        for shape in ((IB, IB), (1000, 37)):
            L = SCAN_LEVELS
            for layout, carry_pos in ewise_layouts():
                args = ewise_args(layout, carry_pos, shape, L, dt)
                same_bits(f"chain_ewise {shape} {dname} {layout} carry "
                          f"{carry_pos}",
                          chain_ops.chain_ewise(layout, carry_pos, L, *args),
                          chain_ref.chain_ewise(layout, carry_pos, L, *args))
                n_ewise += 1
    n_layouts = len(list(ewise_layouts()))
    print(f"[chain] chain_ewise: {n_ewise} cases (f32/bf16/f64/f16 x "
          f"(1024,1024) and (1000,37) x {n_layouts} layouts, {SCAN_LEVELS} "
          f"levels) bitwise equal to the plain version: ok")
    # each layout's device time at the main path's shape
    for layout, carry_pos in ewise_layouts():
        args = ewise_args(layout, carry_pos, (IB, IB), SCAN_LEVELS,
                          torch.float32)
        ms = graph_ms(torch, lambda: chain_ops.chain_ewise(
            layout, carry_pos, SCAN_LEVELS, *args))
        moved = sum(a.numel() for a in args if isinstance(a, torch.Tensor))
        nbytes = (moved + IB * IB) * 4
        bnd, by = bound_ms(nbytes, 2 * SCAN_LEVELS * IB * IB, "float32")
        print(f"[chain] chain_ewise {IB}^2 x {SCAN_LEVELS} float32 {layout} "
              f"carry {carry_pos}: {ms:.4f} ms device time, bound "
              f"{bnd:.4f} ms ({by})")
        del args
    for dname, dt in every.items():
        for m, k, n, L in ((IB, IB, IB, DOT_LEVELS), (130, 70, 260, 3),
                           (130, 72, 264, 3)):
            c = rand((m, n), dt)
            A, B = rand((L, m, k), dt), rand((L, k, n), dt)
            for layout, args in ((("single", "xs", "xs"), (c, A, B)),
                                 (("single", "single", "single"),
                                  (c, A[0], B[0]))):
                # the chain's route is the one replay takes at every level
                # and the one the chain library's launcher takes
                path = chain_ops.dot_route(layout, L, *args)
                per_level = {gemm_route(args[1][lv] if layout[1] == "xs"
                                        else args[1],
                                        args[2][lv] if layout[2] == "xs"
                                        else args[2]) for lv in range(L)}
                strides = [m * k if layout[1] == "xs" else 0,
                           k * n if layout[2] == "xs" else 0]
                launcher = gemm_route(args[1], args[2], *strides,
                                      addresses=chain_ops.level_addresses(
                                          layout, L, args[1], args[2]))
                check(per_level == {path} == {launcher},
                      f"chain_dot {dname} ({m},{k},{n}) {layout}: chain "
                      f"route {path}, launcher {launcher}, replay {per_level}")
                name = (f"chain_dot ({m},{k},{n}) x {L} {dname} {layout} "
                        f"[{path}]")
                got = chain_ops.chain_dot(layout, 0, L, *args)
                same_bits(f"{name} vs gemm_tile replay", got,
                          chain_ref.run_levels(gemm_tile, layout, 0, L, args))
                rtol, atol = TOL[dname]
                exp = chain_ref.chain_dot(layout, 0, L, *args)
                torch.testing.assert_close(got, exp, rtol=rtol, atol=atol * L,
                                           msg=lambda msg: f"{name}: {msg}")
                err = (got.double() - exp.double()).abs().max().item()
                print(f"[chain] {name}: bitwise equal to per-level gemm_tile "
                      f"replay; max_abs_err {err:.3e} against the plain "
                      f"version (rtol {rtol}, atol {atol} x {L} levels)")

    # times and errors at the main path's shapes (float32, and float16 on
    # the same values rounded to it)
    L = SCAN_LEVELS
    y, x = rand((IB, IB), torch.float32), rand((IB, IB), torch.float32)
    xs = rand((L, IB, IB), torch.float32)
    chain_times = {}
    for dname, label, lx, xv in (
            ("float32", "x single", "single", x),
            ("float32", "x per level", "xs", xs),
            ("float16", "x single", "single", x),
            ("float16", "x per level", "xs", xs)):
        layout = ("single", "const", lx)
        y, xv = y.to(every[dname]), xv.to(every[dname])
        got = chain_ops.chain_ewise(layout, 0, L, y, 0.5, xv)
        exp = chain_ref.chain_ewise(layout, 0, L, y, 0.5, xv)
        same_bits(f"chain_ewise {IB}^2 x {L} {dname} {label}", got, exp)
        err = (got.double() - exp.double()).abs().max().item()
        ms = graph_ms(torch, lambda: chain_ops.chain_ewise(layout, 0, L, y,
                                                           0.5, xv))
        host = time_ms(torch, lambda: chain_ops.chain_ewise(layout, 0, L, y,
                                                            0.5, xv))
        plain = time_ms(torch, lambda: chain_ref.chain_ewise(layout, 0, L, y,
                                                             0.5, xv))
        nbytes = (2 * y.numel() + xv.numel()) * y.element_size()
        # two operations an element and level, at the card's peak for the
        # data's type (the kernel's float32 math on the CUDA cores is its
        # choice, not the work's)
        bnd, by = bound_ms(nbytes, 2 * L * y.numel(), dname)
        print(f"[chain] chain_ewise {IB}^2 x {L} levels {dname}, {label}: "
              f"kernel {ms:.4f} ms device time ({nbytes / ms / 1e6:.1f} "
              f"GB/s), wrapper calls back to back {host:.4f} ms, plain "
              f"{plain:.4f} ms, max_abs_err {err:.3e}, no single-call "
              f"library counterpart, bound {bnd:.4f} ms ({by}, "
              f"{nbytes / 1e6:.1f} MB)")
        chain_times[("ewise", lx) if dname == "float32"
                    else ("ewise", lx, dname)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
            bound_by=by, library_ms=None)
    L = DOT_LEVELS
    layout = ("single", "xs", "xs")
    for dname, dt in every.items():
        c = rand((IB, IB), dt)
        A, B = rand((L, IB, IB), dt), rand((L, IB, IB), dt)
        A_cat = torch.cat(list(A), dim=1).contiguous()      # (IB, L*IB)
        B_cat = torch.cat(list(B), dim=0).contiguous()      # (L*IB, IB)
        path = chain_ops.dot_route(layout, L, c, A, B)
        got = chain_ops.chain_dot(layout, 0, L, c, A, B)
        exp = chain_ref.chain_dot(layout, 0, L, c, A, B)
        err = (got.double() - exp.double()).abs().max().item()
        ms = time_ms(torch, lambda: chain_ops.chain_dot(layout, 0, L, c, A,
                                                        B), iters=10)
        plain = time_ms(torch, lambda: chain_ref.chain_dot(layout, 0, L, c,
                                                           A, B), iters=10)
        replay = time_ms(torch, lambda: chain_ref.run_levels(
            gemm_tile, layout, 0, L, (c, A, B)), iters=10)
        lib = time_ms(torch, lambda: torch.addmm(c, A_cat, B_cat), iters=10)
        flops = L * (2 * IB ** 3 + IB * IB)
        nbytes = (2 * IB * IB + A.numel() + B.numel()) * c.element_size()
        bnd, by = bound_ms(nbytes, flops, dname)
        extra = {}
        if dt in vs_routes:
            # the CUDA-core route's chain on the same values (copies at an
            # odd offset): its time, and both routes against float64
            extra = simt_numbers(
                f"chain_dot {IB}^3 x {L} {dname}",
                lambda x, y: chain_ops.chain_dot(layout, 0, L, c, x, y),
                lambda x, y: chain_ops.dot_route(layout, L, c, x, y),
                c.double() + torch.einsum("lmk,lkn->mn", A.double(),
                                          B.double()),
                A, B, ms, flops, nbytes, tag="chain", iters=10,
                limit=(TF32_VS_SIMT if dt == torch.float32
                       else F16_VS_SIMT["float16"]))
            ms = extra.pop("ms")
            bnd, by = extra.pop("bound_ms", bnd), extra.pop("bound_by", by)
        print(f"[chain] chain_dot {IB}^3 x {L} levels {dname} [{path}]: "
              f"kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain "
              f"(per-level PyTorch) {plain:.4f} ms, max_abs_err {err:.3e}, "
              f"per-level gemm_tile replay ({L} GEMM-kernel launches) "
              f"{replay:.4f} ms, torch.addmm over K={L * IB} {lib:.4f} ms, "
              f"bound {bnd:.4f} ms ({by})")
        chain_times[("dot", dname)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
            bound_by=by, library_ms=lib, gemm_route=path, **extra)
        del got, exp, c, A, B, A_cat, B_cat
    print(f"[chain] chain_dot launches by route: {dict(chain_ops.chain_dot.routes)}")
    # every GEMM route, float16's two among them
    check(set(chain_ops.chain_dot.routes) == set(ops.ROUTES),
          f"chain_dot: routes run {sorted(chain_ops.chain_dot.routes)}, "
          f"expected every one of {sorted(ops.ROUTES)}")
    del y, x, xs

    def attn_operands(layout, m, n, d, dv, L, dt):
        shapes = ((m, dv), (m, d), (n, d), (n, dv))
        return tuple(rand(((L,) if lay == "xs" else ()) + shape, dt)
                     for lay, shape in zip(layout, shapes))

    def attn_route_of(name, layout, L, args):
        """The route ``chain_attn.attn_route`` gives these operands,
        checked against the one the built library's launcher takes."""
        o, q, k, v = args
        strides = [t[0].numel() if lay == "xs" else 0
                   for lay, t in zip(layout[1:], (q, k, v))]
        want = chain_ops.attn_route(layout, L, *args)
        got = chain_kernel.launcher_route(
            o.dtype, q.data_ptr(), strides[0], k.data_ptr(), strides[1],
            v.data_ptr(), strides[2], k.shape[-2], k.shape[-1], o.shape[1],
            L)
        check(got == want, f"{name}: the launcher takes {got}, attn_route "
              f"says {want}")
        return want

    attn_layouts = (("single", "single", "xs", "xs"),
                    ("single", "xs", "xs", "xs"),
                    ("single", "single", "single", "single"))
    for dname, dt in every.items():
        for m, n, d, dv, L in (ATTN_TILE + (ATTN_LEVELS,),
                               (100, 70, 40, 24, 3)):
            for layout in attn_layouts:
                args = attn_operands(layout, m, n, d, dv, L, dt)
                path = attn_route_of("chain_attn", layout, L, args)
                want = CHAIN_ATTN_ROUTES[dname][(m, n, d, dv) != ATTN_TILE]
                check(path == want, f"chain_attn ({m},{n},{d},{dv}) "
                      f"{dname}: route {path}, expected {want}")
                name = (f"chain_attn ({m},{n},{d},{dv}) x {L} {dname} "
                        f"{layout[1:]} [{path}]")
                got = chain_ops.chain_attn(layout, 0, L, *args)
                same_bits(f"{name} vs attn_step replay", got,
                          chain_ref.run_levels(attn_step, layout, 0, L, args))
                rtol, atol = TOL[dname]
                exp = chain_ref.chain_attn(layout, 0, L, *args)
                torch.testing.assert_close(got, exp, rtol=rtol, atol=atol * L,
                                           msg=lambda msg: f"{name}: {msg}")
                err = (got.double() - exp.double()).abs().max().item()
                print(f"[chain] {name}: bitwise equal to per-level attn_step "
                      f"replay; max_abs_err {err:.3e} against the plain "
                      f"version (rtol {rtol}, atol {atol} x {L} levels)")

    # ragged shapes on each tensor-core route, one head dim per block
    # configuration (the 3xTF32 block's 64- and 32-key tiles, the wgmma
    # block's 128- and 64-key ones): M not a multiple of the 128-row tile
    # (70 rows: a tile of fewer than 128), N not one of the key tile, so a
    # level of several chunks ends in a partial key tile; in every layout,
    # one level and three
    for dname, m_, n_, d_ in (("float32", 70, 333, 64),
                              ("float32", 200, 333, 80),
                              ("bfloat16", 200, 333, 80),
                              ("bfloat16", 129, 333, 256),
                              ("float16", 200, 333, 80),
                              ("float16", 129, 333, 256)):
        dt = every[dname]
        tc_route = CHAIN_ATTN_ROUTES[dname][0]
        chunks = chain_kernel.attn_chunks(tc_route, m_, n_, d_)
        tile = chain_kernel.key_tile(tc_route, d_)
        check(chunks >= 2 and n_ % tile and m_ % chain_kernel.TC_ROWS,
              f"chain_attn ({m_},{n_},{d_}) {dname}: {chunks} chunks of "
              f"{tile}-key tiles, not a ragged case of several chunks")
        for L in (1, 3):
            for layout in attn_layouts:
                args = attn_operands(layout, m_, n_, d_, d_, L, dt)
                path = attn_route_of("chain_attn ragged", layout, L, args)
                name = (f"chain_attn ({m_},{n_},{d_},{d_}) x {L} {dname} "
                        f"{layout[1:]} [{path}, {chunks} chunks of {tile} "
                        f"keys]")
                check(path == tc_route, f"{name}: not on {tc_route}")
                got = chain_ops.chain_attn(layout, 0, L, *args)
                same_bits(f"{name} vs attn_step replay", got,
                          chain_ref.run_levels(attn_step, layout, 0, L, args))
                rtol, atol = TOL[dname]
                exp = chain_ref.chain_attn(layout, 0, L, *args)
                torch.testing.assert_close(got, exp, rtol=rtol, atol=atol * L,
                                           msg=lambda msg: f"{name}: {msg}")
                err = (got.double() - exp.double()).abs().max().item()
                print(f"[chain] {name}: bitwise equal to per-level attn_step "
                      f"replay; max_abs_err {err:.3e} against the plain "
                      f"version (rtol {rtol}, atol {atol} x {L} levels)")
                del got, exp, args

    # each tensor-core route at the main path's shapes: the 16-level tile
    # and one served level (from a zero carry), against float64 beside the
    # CUDA-core loop on odd-offset copies of the same values, and timed
    # beside it (CUDA graphs: the wrapper's host work is above a level's
    # device time; each side the better of two)
    m, n, d, dv = ATTN_TILE
    layout = attn_layouts[0]
    for dname in ("float32", "bfloat16", "float16"):
        dt = every[dname]
        tc_route, simt_route = CHAIN_ATTN_ROUTES[dname]
        limit = TF32_VS_SIMT if dname == "float32" else CHAIN_HALF_VS_SIMT
        for what, L in (("16 levels", ATTN_LEVELS), ("one served level", 1)):
            args = attn_operands(layout, m, n, d, dv, L, dt)
            if L == 1:
                args = (torch.zeros_like(args[0]),) + args[1:]
            odd = (args[0],) + tuple(odd_offset(t) for t in args[1:])
            label = f"chain_attn ({m},{n},{d},{dv}) {what} {dname}"
            check(attn_route_of(label, layout, L, args) == tc_route
                  and attn_route_of(label, layout, L, odd) == simt_route,
                  f"{label}: routes {chain_ops.attn_route(layout, L, *args)}"
                  f" / {chain_ops.attn_route(layout, L, *odd)}")
            got = chain_ops.chain_attn(layout, 0, L, *args)
            simt = chain_ops.chain_attn(layout, 0, L, *odd)
            exp = chain_ref.chain_attn(layout, 0, L, *args)
            exact = chain_attn64(torch, layout, L, *args)
            err = (got.double() - exp.double()).abs().max().item()
            rtol, atol = TOL[dname]
            torch.testing.assert_close(got, exp, rtol=rtol, atol=atol * L,
                                       msg=lambda msg: f"{label}: {msg}")
            err64 = (got.double() - exact).abs().max().item()
            simt64 = (simt.double() - exact).abs().max().item()
            ratio = err64 / max(simt64, 1e-30)
            check(ratio <= limit, f"{label}: {tc_route}'s float64 error "
                  f"{err64:.3e} is {ratio:.2f}x {simt_route}'s {simt64:.3e}"
                  f", above {limit}")
            ms = min(graph_ms(torch, lambda: chain_ops.chain_attn(
                layout, 0, L, *args)) for _ in range(2))
            simt_ms = min(graph_ms(torch, lambda: chain_ops.chain_attn(
                layout, 0, L, *odd)) for _ in range(2))
            check(ms < simt_ms, f"{label}: {tc_route} {ms:.4f} ms is not "
                  f"below {simt_route}'s {simt_ms:.4f} on the same values")
            plain = time_ms(torch, lambda: chain_ref.chain_attn(
                layout, 0, L, *args))
            replay = time_ms(torch, lambda: chain_ref.run_levels(
                attn_step, layout, 0, L, args))
            flops = L * (2 * m * n * d + 2 * m * n * dv)
            nbytes = (2 * m * dv + m * d + L * n * (d + dv)) * dt.itemsize
            # the products at the card's peak for the route's arithmetic:
            # three TF32 products in float32, the 16-bit tensor cores
            # otherwise; the CUDA-core loop's at 67 TFLOP/s
            bnd, by = (bound_ms(nbytes, TF32_PRODUCTS * flops, "tf32")
                       if dname == "float32"
                       else bound_ms(nbytes, flops, dname))
            simt_bnd, _ = bound_ms(nbytes, flops, "float32")
            chunks = chain_kernel.attn_chunks(tc_route, m, n, d)
            print(f"[chain] {label} [{tc_route}, {chunks} chunks a level, "
                  f"{-(-m // chain_kernel.TC_ROWS) * chunks * L} blocks]: "
                  f"kernel {ms:.4f} ms device time ({flops / ms / 1e9:.2f} "
                  f"TFLOP/s), bound {bnd:.4f} ms ({by}; {bnd / ms:.3f} of "
                  f"it); {simt_route} on the same values {simt_ms:.4f} ms "
                  f"({simt_ms / ms:.2f}x slower, bound {simt_bnd:.4f} ms at "
                  f"67 TFLOP/s); float64 error {err64:.3e} = {ratio:.2f}x "
                  f"{simt_route}'s {simt64:.3e} (limit {limit}); plain "
                  f"(per-level PyTorch) {plain:.4f} ms, max_abs_err "
                  f"{err:.3e}; per-level attn_step replay ({L} chain_attn "
                  f"launches) {replay:.4f} ms; no single-call library "
                  f"counterpart")
            numbers = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=bnd, bound_by=by, library_ms=None,
                           chain_route=tc_route, chunks=chunks,
                           simt_ms=simt_ms, simt_bound_ms=simt_bnd,
                           err64=err64, simt_err64=simt64, vs_simt=ratio)
            key = ("attn", dname) if L > 1 else ("attn", dname, "served")
            chain_times[key] = numbers
            del got, simt, exp, exact, args, odd
    chain_times["attn"] = chain_times.pop(("attn", "float32"))
    # chains whose workspace passes one launch's (WORKSPACE_BYTES): several
    # launches, the carry handed on in its own type, still bit for bit
    # per-level replay; on every tensor-core route, the CUDA-core loop
    # (float32 at an odd offset) and float64
    n = 64
    for dname, full_runs, at_odd in (("float32", 1, False),
                                     ("bfloat16", 1, False),
                                     ("float16", 1, False),
                                     ("float32", 1, True),
                                     ("float64", 2, False)):
        dt = every[dname]
        path = CHAIN_ATTN_ROUTES[dname][at_odd]
        per_launch = chain_kernel.levels_per_launch(path, m, n, d, dv, dt)
        L = full_runs * per_launch + per_launch // 4 + 1
        args = attn_operands(layout, m, n, d, dv, L, dt)
        if at_odd:
            args = (args[0],) + tuple(odd_offset(t) for t in args[1:])
        check(attn_route_of("chain_attn multi-launch", layout, L, args)
              == path, f"chain_attn x {L} {dname}: not on {path}")
        chunks = (chain_kernel.attn_chunks(path, m, n, d)
                  if path in chain_kernel.TC_ROUTES else None)
        runs = chain_kernel.level_runs(m, dv, dt, L, chunks)
        check(runs[0][1] == per_launch, f"chain_attn x {L} {dname}: runs of "
              f"{runs[0][1]} levels, levels_per_launch says {per_launch}")
        before = chain_ops.chain_attn.launches
        got = chain_ops.chain_attn(layout, 0, L, *args)
        launched = chain_ops.chain_attn.launches - before
        check(launched == len(runs) > 1, f"chain_attn x {L} {dname}: "
              f"{launched} launches, expected {len(runs)} (> 1)")
        name = (f"chain_attn ({m},{n},{d},{dv}) x {L} {dname} [{path}] in "
                f"{launched} launches of at most {runs[0][1]} levels")
        same_bits(f"{name} vs attn_step replay", got,
                  chain_ref.run_levels(attn_step, layout, 0, L, args))
        print(f"[chain] {name}: bitwise equal to per-level attn_step replay")
        del got, args
    print(f"[chain] chain_attn launches by route: "
          f"{dict(chain_ops.chain_attn.routes)}")
    # every route: the three tensor-core routes and the four CUDA-core ones
    check(set(chain_ops.chain_attn.routes) == set(chain_ops.ATTN_ROUTES),
          f"chain_attn: routes run {sorted(chain_ops.chain_attn.routes)}, "
          f"expected every one of {sorted(chain_ops.ATTN_ROUTES)}")
    check(not any(buf.any().item() for buf in chain_kernel._COUNTERS.values()),
          "chain_attn: a counter left non-zero")

    def device_mallocs():
        # segments the caching allocator has taken with cudaMalloc so far
        return torch.cuda.memory_stats(dev).get("num_device_alloc", 0)

    def freed(label, base):
        # the finished workflow, its executor and every tile must go with
        # the last reference to them, not at the next cyclic collection
        left = torch.cuda.memory_allocated(dev) - base
        print(f"[{label}] device memory held after the run: {left} bytes")
        check(left < IB * IB * 4, f"{label}: {left} bytes still allocated "
              f"after the workflow was dropped")

    wrappers = {"gemm.matmul": ops.matmul,
                "gemm.matmul_accumulate": ops.matmul_accumulate,
                "chain.ewise": chain_ops.chain_ewise,
                "chain.dot": chain_ops.chain_dot,
                "chain.attn": chain_ops.chain_attn,
                "flash_attention": fa_ops.flash_attention,
                "flash_attention_bwd": fa_ops.flash_attention_bwd,
                "linear_scan": ls_ops.linear_scan}

    # the tensor bodies' expressions, taken where a kernel refuses the
    # operands: no main-path op may take them
    bodies = {"body.gemm": ops.accumulate_body, "body.attn": fa_ops.step_body}

    def zero_counts():
        for wrapper in wrappers.values():
            wrapper.launches = 0
            if hasattr(wrapper, "routes"):
                wrapper.routes = {}
        for body in bodies.values():
            body.calls = 0

    def counts():
        return {**{name: w.launches for name, w in wrappers.items()},
                **{name: b.calls for name, b in bodies.items()}}

    def only(label, got, name, want):
        check(got[name] == want, f"{label}: {got[name]} {name} launches, "
              f"expected {want}")
        others = {k: v for k, v in got.items() if k != name and v}
        check(not others, f"{label}: unexpected launches {others}")

    def measured(label, run, describe, keep=lambda result: None):
        """Run ``run`` cold then warm with every count zeroed just before
        it and read just after; checks each run with ``describe`` and that
        dropping its result gives the device memory back (all but the
        tensor ``keep`` picks from the warm run's result).  Gives back
        ``(kept tensor, the warm run's counts, walls)``."""
        walls = {}
        kept = None
        for phase in ("cold", "warm"):
            zero_counts()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            mallocs = device_mallocs()
            t0 = time.perf_counter()
            result = run()
            torch.cuda.synchronize()
            walls[phase] = time.perf_counter() - t0
            got = counts()
            describe(phase, result, got, walls[phase],
                     device_mallocs() - mallocs)
            if phase == "warm":
                kept = keep(result)
                if kept is not None:
                    base += kept.untyped_storage().nbytes()
            del result
            freed(label, base)
        return kept, got, walls

    path_counts = {}

    def warm_wall(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    lap("[chain]")

    # -- 4b. flash attention against its plain version -----------------------
    def attn_inputs(b, hq, hkv, sq, skv, d, dt):
        return (rand((b, hq, sq, d), dt), rand((b, hkv, skv, d), dt),
                rand((b, hkv, skv, d), dt))

    def attn_compare(name, got, q, k, v, causal, window, blk, dname):
        """``got`` against the plain version (the oracle on the padded
        inputs) at the reference's tolerance and, in bfloat16 and float16,
        against the float32 oracle on the same inputs to the dtype's limits
        scaled to each value (``half_attention_error``).  Returns the
        largest error."""
        sq = q.shape[2]
        padded = fa_ops.pad(q, k, v, causal=causal, window=window, bq=blk,
                            bkv=blk)
        exp = fa_ref.attention(*padded, causal=causal,
                               window=window)[:, :, :sq]
        tol = ATTN_TOL[dname]
        err = close("attn", name, got, exp, tol, tol)
        if dname in HALF_LIMITS:
            del exp
            exp32 = fa_ref.attention(*(t.float() for t in padded),
                                     causal=causal, window=window)[:, :, :sq]
            stats = half_attention_error(got, exp32, padded[2])
            _, _, slice_lim, row_lim = HALF_LIMITS[dname]
            print(f"[attn]   {dname} limits: element {stats['element']:.3f} "
                  f"of its limit (<= 1), slice rms {stats['slice']:.3e} (<= "
                  f"{slice_lim:.3e}), row rms {stats['row']:.3e} (<= "
                  f"{row_lim:.3e})")
            check(half_within(stats, dname), f"{name}: outside the {dname} "
                  f"limits: {stats}")
        return err

    tf32_ratios = []

    def tf32_accuracy(name, got, q, k, v, causal, window, blk):
        """f32_3xtf32's ``got`` against float64, beside f32_simt's error on
        the same padded values (copies at an odd offset take f32_simt), per
        slice of at most 8 heads: at most TF32_VS_SIMT times it."""
        padded = fa_ops.pad(q, k, v, causal=causal, window=window, bq=blk,
                            bkv=blk)
        copies = [odd_offset(t) for t in padded]
        check(fa_ops.route(torch.float32, q.shape[3],
                           [t.data_ptr() for t in copies]) == "f32_simt",
              f"{name}: the odd-offset copies do not take f32_simt")
        sq, hq = q.shape[2], q.shape[1]
        # padded already: bq, bkv at the padded lengths pad nothing more
        simt = fa_ops.flash_attention(*copies, causal=causal, window=window,
                                      bq=copies[0].shape[2],
                                      bkv=copies[1].shape[2])[:, :, :sq]
        del copies
        err, base, ratio = 0.0, 0.0, 0.0
        for h0 in range(0, hq, 8):
            heads = range(h0, min(hq, h0 + 8))
            exp = attention64(torch, fa_ref, *padded, causal, window,
                              heads)[:, :, :sq]
            e = (got[:, h0:h0 + 8].double() - exp).abs().max().item()
            b = (simt[:, h0:h0 + 8].double() - exp).abs().max().item()
            check(e <= TF32_VS_SIMT * b,
                  f"{name} heads {h0}-{heads[-1]}: {e:.3e} from float64, "
                  f"{e / max(b, 1e-30):.2f} x f32_simt's {b:.3e} (limit "
                  f"{TF32_VS_SIMT})")
            if e / max(b, 1e-30) >= ratio:
                err, base, ratio = e, b, e / max(b, 1e-30)
            del exp
        tf32_ratios.append(ratio)
        print(f"[attn]   against float64: {err:.3e}, f32_simt {base:.3e} on "
              f"the same inputs ({ratio:.2f} x, limit {TF32_VS_SIMT})")

    def attn_run(q, k, v, *, causal, window, bq=512, bkv=512):
        """``flash_attention`` through its entry point: one launch, counted
        on the route ``ops.route`` gives q, k and v.  (The wrapper asks the
        built launcher for the route of the very operands it launches on,
        holds it against ``ops.route`` and counts it; where it pads, it
        copies into fresh aligned tensors, as the inputs here are.)
        Returns (output, route)."""
        want = fa_ops.route(q.dtype, q.shape[3],
                            [t.data_ptr() for t in (q, k, v)])
        before = dict(fa_ops.flash_attention.routes)
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     bq=bq, bkv=bkv)
        counted = {r: n - before.get(r, 0)
                   for r, n in fa_ops.flash_attention.routes.items()
                   if n != before.get(r, 0)}
        check(counted == {want: 1}, f"flash attention: launches counted by "
              f"route {counted}, expected one on {want}")
        return out, want

    print(f"[attn] route rule: f32_3xtf32 for float32 with d in "
          f"{fa_ops.TF32_HEAD_DIMS} and q, k, v, out 16-byte aligned, "
          f"f32_simt for any other float32; bf16_wgmma for bfloat16 with d in "
          f"{fa_ops.WGMMA_HEAD_DIMS} and the operands 16-byte aligned, "
          f"bf16_simt for any other bfloat16; f16_wgmma / f16_simt for "
          f"float16 by bfloat16's rule")
    small = [("", case, 16, "float32") for case in ATTN_CASES]
    small.append(("", (1, 4, 2, 64, 64, 16, True, None), 32, "bfloat16"))
    small.append(("", (1, 4, 2, 64, 64, 16, True, None), 32, "float16"))
    # the reference's cases again at head dims the tensor cores take, and
    # rows past Skv + window that see no key
    for d in (64, 128):
        for dname in ("float32", "bfloat16", "float16"):
            small += [("", case[:5] + (d,) + case[6:], 16, dname)
                      for case in ATTN_CASES]
            small.append(("", (1, 2, 2, 64, 32, d, True, 8), 16, dname))
    # many key tiles per query tile, at every head dim of the tensor cores
    # (float32 at the 3xTF32 route's d 64, 80, 96 and 128)
    for d in MID_HEAD_DIMS:
        for dname in ("float32", "bfloat16", "float16"):
            if dname == "float32" and fa_ops.route(
                    torch.float32, d) != "f32_3xtf32":
                continue
            small += [(" mid", (b, hq, hkv, sq, skv, d, causal, window), blk,
                       dname)
                      for b, hq, hkv, sq, skv, causal, window, blk in MID_ATTN]
    odd_model, (b, hq, hkv, s, d, window) = ODD_ATTN
    small.append((f" {odd_model}", (b, hq, hkv, s, s, d, True, window), 512,
                  "bfloat16"))
    fa_ops.flash_attention.routes = {}
    for model, (b, hq, hkv, sq, skv, d, causal, window), blk, dname in small:
        q, k, v = attn_inputs(b, hq, hkv, sq, skv, d, getattr(torch, dname))
        got, path = attn_run(q, k, v, causal=causal, window=window, bq=blk,
                             bkv=blk)
        name = (f"flash_attention{model} {(b, hq, hkv, sq, skv, d)} causal "
                f"{causal} window {window} {dname} [{path}]")
        attn_compare(name, got, q, k, v, causal, window, blk, dname)
        if path == "f32_3xtf32":
            tf32_accuracy(name, got, q, k, v, causal, window, blk)
        # bf16 and f16 at every head dim of WGMMA_HEAD_DIMS take the
        # tensor cores (h2o-danube's d 80 and MID_ATTN's d 80 / 96 among
        # them)
        wgmma = fa_ops.WGMMA_ROUTES.get(getattr(torch, dname), (None,))[0]
        check(wgmma is None or d not in fa_ops.WGMMA_HEAD_DIMS
              or path == wgmma, f"{name}: took {path}, expected {wgmma}")
        seen = fa_ref.mask(sq, skv, causal=causal, window=window, device=dev)
        blind = ~seen.any(dim=-1)
        if blind.any():
            check(not got[:, :, blind].any().item(),
                  f"flash attention {dname} d {d}: a row that sees no key "
                  f"is not exactly zero")
            print(f"[attn]   {int(blind.sum())} rows see no key: exactly "
                  f"zero")
    # contiguous bf16 views one element (2 bytes) into their storage, at a
    # head dim the tensor cores take: TMA cannot read them, so the
    # launcher must send them to the CUDA-core loop
    shape = (1, 2, 256, 128)
    q, k, v = (rand((shape[0] * shape[1] * shape[2] * shape[3] + 1,),
                    torch.bfloat16)[1:].view(shape) for _ in range(3))
    got, path = attn_run(q, k, v, causal=True, window=None, bq=256, bkv=256)
    check(path == "bf16_simt", f"flash attention on views at an odd offset "
          f"took {path}, expected bf16_simt")
    attn_compare(f"flash_attention (1, 2, 2, 256, 256, 128) causal True "
                 f"bfloat16, views at an odd 2-byte offset [{path}]", got, q,
                 k, v, True, None, 256, "bfloat16")
    # and at Phi-3-vision's d 96, whose aligned operands take the tensor
    # cores: a view one element in still goes to the CUDA-core loop
    shape96 = (1, 2, 256, 96)
    q, k, v = (odd_offset(rand(shape96, torch.bfloat16)) for _ in range(3))
    got, path = attn_run(q, k, v, causal=True, window=None, bq=256, bkv=256)
    check(path == "bf16_simt", f"flash attention at d 96 on views at an odd "
          f"offset took {path}, expected bf16_simt")
    attn_compare(f"flash_attention (1, 2, 2, 256, 256, 96) causal True "
                 f"bfloat16, views at an odd 2-byte offset [{path}]", got, q,
                 k, v, True, None, 256, "bfloat16")
    # float16 views one element in, at d 128 and 96, where aligned ones
    # take f16_wgmma: the CUDA-core loop
    for shape_ in (shape, shape96):
        q, k, v = (odd_offset(rand(shape_, torch.float16)) for _ in range(3))
        got, path = attn_run(q, k, v, causal=True, window=None, bq=256,
                             bkv=256)
        check(path == "f16_simt", f"flash attention on float16 views at an "
              f"odd offset (d {shape_[3]}) took {path}, expected f16_simt")
        b_, h_, s_, d_ = shape_
        attn_compare(f"flash_attention {(b_, h_, h_, s_, s_, d_)} causal "
                     f"True float16, views at an odd 2-byte offset [{path}]",
                     got, q, k, v, True, None, 256, "float16")
    # and float32 views one element (4 bytes) in: the 3xTF32 loop's 16-byte
    # loads cannot read them, so they take the CUDA cores
    q, k, v = (odd_offset(rand(shape, torch.float32)) for _ in range(3))
    got, path = attn_run(q, k, v, causal=True, window=None, bq=256, bkv=256)
    check(path == "f32_simt", f"flash attention on float32 views at an odd "
          f"offset took {path}, expected f32_simt")
    attn_compare(f"flash_attention (1, 2, 2, 256, 256, 128) causal True "
                 f"float32, views at an odd 4-byte offset [{path}]", got, q,
                 k, v, True, None, 256, "float32")
    del q, k, v, got
    print(f"[attn] f32_3xtf32 against float64: at most "
          f"{max(tf32_ratios):.2f} x f32_simt's error over "
          f"{len(tf32_ratios)} cases (limit {TF32_VS_SIMT})")
    print(f"[attn] launches by route: {fa_ops.flash_attention.routes}")
    attn_route_launches = dict(fa_ops.flash_attention.routes)
    check(set(fa_ops.flash_attention.routes) == set(fa_ops.ROUTES),
          f"flash attention: routes run "
          f"{sorted(fa_ops.flash_attention.routes)}, expected every one of "
          f"{fa_ops.ROUTES}")

    attn_times = {}
    for model, (b, hq, hkv, s, d, window) in FULL_ATTN.items():
        for dname in ("float32", "bfloat16") + (
                ("float16",) if model in FULL_ATTN_F16 else ()):
            dt = getattr(torch, dname)
            label = f"flash_attention {model} {dname}"
            q, k, v = attn_inputs(b, hq, hkv, s, s, d, dt)

            def run(q=q, k=k, v=v, window=window):
                return fa_ops.flash_attention(q, k, v, causal=True,
                                              window=window)

            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, path = attn_run(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            path_counts[label] = counts()
            only(label, path_counts[label], "flash_attention", 1)
            want = fa_ops.route(dt, d, [t.data_ptr() for t in (q, k, v)])
            check(fa_ops.flash_attention.routes == {want: 1},
                  f"{label}: routes {fa_ops.flash_attention.routes}, "
                  f"expected {want}")
            name = (f"{label} (1, {hq}, {hkv}, {s}, {s}, {d}) window "
                    f"{window} [{path}]")
            err = attn_compare(name, got, q, k, v, True, window, 512, dname)
            if path == "f32_3xtf32":
                tf32_accuracy(name, got, q, k, v, True, window, 512)
            if dname == "float16":
                # no atomics: a second call gives the same bits
                again = run()
                check(torch.equal(bits(torch, got), bits(torch, again)),
                      f"{label}: two calls differ")
                del again
            del got
            ms = time_ms(torch, run, iters=5, warmup=1)
            plain = time_ms(torch, lambda q=q, k=k, v=v, window=window:
                            fa_ref.attention(q, k, v, causal=True,
                                             window=window),
                            iters=2, warmup=1)
            if window is None:
                lib = time_ms(torch, lambda q=q, k=k, v=v:
                              torch.nn.functional.scaled_dot_product_attention(
                                  q, k, v, is_causal=True, enable_gqa=True),
                              iters=5, warmup=1)
            else:
                seen = fa_ref.mask(s, s, causal=True, window=window,
                                   device=dev)
                lib = time_ms(torch, lambda q=q, k=k, v=v, seen=seen:
                              torch.nn.functional.scaled_dot_product_attention(
                                  q, k, v, attn_mask=seen, enable_gqa=True),
                              iters=5, warmup=1)
                del seen
            flops = 4 * b * hq * d * visible_pairs(s, window)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            simt = {}
            if path == "f32_3xtf32":
                bnd, by = bound_ms(nbytes, TF32_PRODUCTS * flops, "tf32")
                simt_bnd, _ = bound_ms(nbytes, flops, "float32")
                print(f"[attn] {label}: bound {bnd:.4f} ms at three TF32 "
                      f"products ({TF32_PRODUCTS} x {flops:.3e} FLOP at "
                      f"{PEAK_FLOPS['tf32'] / 1e12:.0f} TFLOP/s); on the "
                      f"CUDA cores it would be {simt_bnd:.4f} ms")
                if d == 256:
                    # the CUDA-core loop that d 256 ran before, on the same
                    # values (q one element in), which it must beat
                    odd = odd_offset(q)
                    fa_ops.flash_attention.routes = {}
                    simt_out = fa_ops.flash_attention(
                        odd, k, v, causal=True, window=window)
                    check(fa_ops.flash_attention.routes == {"f32_simt": 1},
                          f"{label}: q one element in took "
                          f"{fa_ops.flash_attention.routes}")
                    simt_err = (simt_out.double() - fa_ref.attention(
                        q, k, v, causal=True, window=window).double()
                    ).abs().max().item()
                    del simt_out
                    simt_ms = time_ms(torch, lambda odd=odd, k=k, v=v,
                                      window=window: fa_ops.flash_attention(
                                          odd, k, v, causal=True,
                                          window=window), iters=3, warmup=1)
                    del odd
                    check(ms < simt_ms, f"{label}: f32_3xtf32 {ms:.3f} ms is "
                          f"not below f32_simt's {simt_ms:.3f}")
                    simt = dict(simt_ms=simt_ms, simt_max_abs_err=simt_err,
                                simt_bound_ms=simt_bnd)
                    print(f"[attn] {label}: f32_simt on the same values (q "
                          f"one element in) {simt_ms:.3f} ms, max_abs_err "
                          f"{simt_err:.3e} against the plain version; "
                          f"f32_3xtf32 {simt_ms / ms:.2f}x faster")
            else:
                bnd, by = bound_ms(nbytes, flops, dname)
            if dname == "float16":
                # the CUDA-core loop on the same values (q, k, v one
                # element into their storage), which f16_wgmma must beat,
                # as it must the plain version
                odd = [odd_offset(x) for x in (q, k, v)]
                fa_ops.flash_attention.routes = {}
                simt_out = fa_ops.flash_attention(*odd, causal=True,
                                                  window=window)
                check(fa_ops.flash_attention.routes == {"f16_simt": 1},
                      f"{label}: q, k, v one element in took "
                      f"{fa_ops.flash_attention.routes}")
                simt_err = (simt_out.double() - fa_ref.attention(
                    q, k, v, causal=True, window=window).double()
                ).abs().max().item()
                del simt_out
                simt_ms = time_ms(torch, lambda odd=odd, window=window:
                                  fa_ops.flash_attention(
                                      *odd, causal=True, window=window),
                                  iters=3, warmup=1)
                del odd
                check(ms < simt_ms and ms < plain, f"{label}: f16_wgmma "
                      f"{ms:.3f} ms is not below f16_simt's {simt_ms:.3f} "
                      f"and the plain version's {plain:.3f}")
                simt = dict(simt_ms=simt_ms, simt_max_abs_err=simt_err)
                print(f"[attn] {label}: f16_simt on the same values (q, k, "
                      f"v one element in) {simt_ms:.3f} ms, max_abs_err "
                      f"{simt_err:.3e} against the plain version; f16_wgmma "
                      f"{simt_ms / ms:.2f}x faster, two calls bit for bit")
            print(f"[attn] {label} [{path}]: first call {wall * 1e3:.3f} ms "
                  f"wall; kernel {ms:.3f} ms ({flops / ms / 1e9:.2f} TFLOP/s), "
                  f"plain {plain:.3f} ms, scaled_dot_product_attention "
                  f"{lib:.3f} ms, "
                  f"bound {bnd:.4f} ms ({by}, {flops:.3e} FLOP)")
            attn_times[(model, dname)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=lib, attn_route=path, **simt)
            if (model, dname) == ("RecurrentGemma-9B", "float32"):
                device_profile(torch, label, run, warm_wall(run),
                               {"flash_attention_tf32_kernel": 1,
                                "flash_attention_kernel": 0})
            if (model, dname) == ("Qwen3-14B", "float32"):
                device_profile(torch, label, run, warm_wall(run),
                               {"flash_attention_tf32_kernel": 1,
                                "flash_attention_kernel": 0})
            if (model, dname) == ("Qwen3-14B", "bfloat16"):
                device_profile(torch, label, run, warm_wall(run),
                               {"flash_attention_wgmma_kernel": 1,
                                "flash_attention_kernel": 0})
            del q, k, v, run

    lap("[attn]")

    # -- 4c. linear scan against its plain versions ---------------------------
    def decay(shape, dt):
        # a in (0.2, 0.99), a forget gate's range, as the reference's tests
        return (torch.rand(shape, generator=gen, device=dev) * 0.79
                + 0.2).to(dt)

    def scan_compare(name, got, exp, dname):
        tol = SCAN_TOL[dname]
        return close("scan", name, got, exp, tol, tol)

    def scan_run(a, x, bs=32):
        """``linear_scan`` through its entry point: one launch, counted on
        the route ``ops.route`` gives a and x (the wrapper asks the built
        launcher and holds it against ``ops.route``; where it pads, it
        copies into fresh aligned tensors).  Returns (output, route)."""
        s = a.shape[1]
        padded = (-s) % max(1, min(bs, s))
        want = ls_ops.route(a.dtype, a.shape[2],
                            () if padded else (a.data_ptr(), x.data_ptr()))
        before = dict(ls_ops.linear_scan.routes)
        out = ls_ops.linear_scan(a, x, bs=bs)
        counted = {r: n - before.get(r, 0)
                   for r, n in ls_ops.linear_scan.routes.items()
                   if n != before.get(r, 0)}
        check(counted == {want: 1}, f"linear scan: launches counted by route "
              f"{counted}, expected one on {want}")
        return out, want

    def scan_bits(name, got, a, x):
        # the kernel is the chunked algorithm: its plain version bit for bit
        exp = ls_ref.linear_scan_chunked(a, x, chunk=ls_kernel.CHUNK)
        torch.cuda.synchronize()
        check(torch.equal(bits(torch, got), bits(torch, exp)),
              f"{name}: not bit for bit ref.linear_scan_chunked")

    print(f"[scan] route rule: tma where a and x are 16-byte aligned and a "
          f"row of D elements is a multiple of 16 bytes, ldg (coalesced "
          f"loads) for any other operands; chunks of {ls_kernel.CHUNK} steps, "
          f"one launch a call")
    ls_ops.linear_scan.routes = {}
    for dname in ("float32", "bfloat16", "float16"):
        dt = getattr(torch, dname)
        for shape in (*SCAN_SHAPES, *LONG_SCANS, FULL_SCAN):
            a, x = decay(shape, dt), rand(shape, dt)
            label = f"linear_scan {shape} {dname}"
            got, path = scan_run(a, x)
            scan_compare(f"{label} ({path})", got,
                         ls_ref.linear_scan(a, x), dname)
            scan_bits(label, got, a, x)
            # the same values one element into their storage: no padding
            # (bs = S), so the kernel reads the odd-offset views themselves
            a_odd, x_odd = odd_offset(a), odd_offset(x)
            odd, path_odd = scan_run(a_odd, x_odd, bs=shape[1])
            check(path_odd == "ldg", f"{label} odd offset: route {path_odd}")
            torch.cuda.synchronize()
            check(torch.equal(bits(torch, odd), bits(torch, got)),
                  f"{label}: the {path_odd} route's bits differ from the "
                  f"{path} route's")
            zero, _ = scan_run(torch.zeros_like(a), x)
            torch.cuda.synchronize()
            check(torch.equal(zero, x), f"{label}: a = 0 does not give x")
            print(f"[scan] {label}: routes {path} and {path_odd} (odd "
                  f"offset) bit for bit ref.linear_scan_chunked and each "
                  f"other; a = 0 gives x exactly")
            del a, x, got, a_odd, x_odd, odd, zero
    # a published aggregate or carry is never the all-ones "not yet" word
    # the kernel polls for: NaNs whose every bit is set, in a and in x,
    # must come out as the chunked plain version's (NaN where it is NaN,
    # every other value bit for bit) and never stall a look-back
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        shape = LONG_SCANS[1]
        a32, x32 = decay(shape, torch.float32), rand(shape, torch.float32)
        ones = torch.tensor(-1, dtype=torch.int32, device=dev).view(
            torch.float32)
        for t in (a32, x32):
            hit = torch.randint(0, t.numel(), (t.numel() // 50000,),
                                generator=gen, device=dev)
            t.view(-1)[hit] = ones
        a, x = a32.to(dt), x32.to(dt)
        got, path = scan_run(a, x)
        exp = ls_ref.linear_scan_chunked(a, x, chunk=ls_kernel.CHUNK)
        torch.cuda.synchronize()
        nan = exp.isnan()
        check(torch.equal(got.isnan(), nan) and torch.equal(
            bits(torch, got[~nan]), bits(torch, exp[~nan])),
              f"linear_scan {shape} {dname} with all-ones NaNs: not the "
              f"chunked plain version's")
        print(f"[scan] linear_scan {shape} {dname} ({path}) with all-ones "
              f"NaNs in a and x: {int(nan.sum())} NaN outputs where the "
              f"chunked plain version has them, every other value bit for "
              f"bit")
        del a32, x32, a, x, got, exp, nan
    print(f"[scan] launches by route: {ls_ops.linear_scan.routes}")
    check(set(ls_ops.linear_scan.routes) == set(ls_ops.ROUTES),
          f"linear scan: routes run {sorted(ls_ops.linear_scan.routes)}, "
          f"expected every one of {sorted(ls_ops.ROUTES)}")
    # a in (0.999, 1] keeps a chunk's carry alive (0.999^128 ≈ 0.88); the
    # reference's range forgets it within a chunk (0.6^128 ≈ 1e-28), so
    # only this checks the carry across chunks.  Over such long memory a
    # float32 scan strays from the exact recurrence by more than 2e-5 (the
    # rounding of sums over ~1000 steps), so the kernel is held to a
    # float64 run of its own chunked order within the worst case of
    # float32 rounding along it (scan_rounding_bound), a bound that no
    # draw can break and a lost or misplaced carry (an error of the order
    # of |h|) cannot meet; the float64 recurrence and the f32 loop's
    # distance from it are printed beside.  The kernel stays no farther
    # from the float64 recurrence than the f32 loop on some draws only
    # (both orders round alike), so that is read over SCAN_SEEDS seeds and
    # printed, not checked
    def scan_f64(a, x):
        h = torch.zeros_like(x[:, 0], dtype=torch.float64)
        y = torch.empty(x.shape, dtype=torch.float64, device=x.device)
        for t in range(x.shape[1]):
            h = a[:, t].double() * h + x[:, t].double()
            y[:, t] = h
        return y

    def scan_f64_chunked(a, x, chunk=ls_kernel.CHUNK):
        """ref.linear_scan_chunked's three steps in float64; returns the
        output and the largest |chunk aggregate| of step 1."""
        b, s, d = a.shape
        n = -(-s // chunk)
        pad = n * chunk - s
        a64 = torch.nn.functional.pad(a.double(), (0, 0, 0, pad), value=1.0)
        x64 = torch.nn.functional.pad(x.double(), (0, 0, 0, pad))
        a64, x64 = a64.view(b, n, chunk, d), x64.view(b, n, chunk, d)
        prod = torch.ones((b, n, d), dtype=torch.float64, device=dev)
        agg = torch.zeros((b, n, d), dtype=torch.float64, device=dev)
        agg_max = 0.0
        for t in range(chunk):
            agg = a64[:, :, t] * agg + x64[:, :, t]
            prod = prod * a64[:, :, t]
            agg_max = torch.maximum(torch.as_tensor(agg_max, device=dev),
                                    agg.abs().max())
        carry = torch.empty_like(agg)
        h = torch.zeros((b, d), dtype=torch.float64, device=dev)
        for c in range(n):
            carry[:, c] = h
            h = prod[:, c] * h + agg[:, c]
        y = torch.empty_like(a64)
        h = carry
        for t in range(chunk):
            h = a64[:, :, t] * h + x64[:, :, t]
            y[:, :, t] = h
        return y.view(b, n * chunk, d)[:, :s], float(agg_max)

    def near_one(shape, g):
        return (1 - torch.rand(shape, generator=g, device=dev) * 1e-3,
                torch.randn(shape, generator=g, device=dev))

    for shape in (LONG_SCANS[0], FULL_SCAN):
        a, x = near_one(shape, gen)
        exact = scan_f64(a, x)
        chunked, agg_max = scan_f64_chunked(a, x)
        got, path = scan_run(a, x, bs=256)
        scan_bits(f"linear_scan {shape} a in (0.999, 1]", got, a, x)
        err = (got.double() - chunked).abs().max().item()
        err_exact = (got.double() - exact).abs().max().item()
        err_plain = (ls_ref.linear_scan(a, x).double()
                     - exact).abs().max().item()
        big = max(chunked.abs().max().item(), agg_max)
        bound = scan_rounding_bound(shape[1], ls_kernel.CHUNK) * big
        check(bool(torch.isfinite(got).all()) and err <= bound
              and err_exact <= bound,
              f"linear_scan {shape} a in (0.999, 1]: {err:.3e} from a float64 "
              f"run of the chunked order, {err_exact:.3e} from the float64 "
              f"recurrence, over the rounding bound {bound:.3e}")
        print(f"[scan] linear_scan {shape} a in (0.999, 1] float32 ({path}): "
              f"max_abs_err {err:.3e} from a float64 run of the chunked "
              f"order, {err_exact:.3e} from the float64 recurrence, within "
              f"the worst case of float32 rounding {bound:.3e} (largest "
              f"|value| {big:.3e}); the f32 loop {err_plain:.3e} from the "
              f"float64 recurrence: ok")
    del a, x, exact, chunked, got
    nearer = []
    for seed in range(SCAN_SEEDS):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        a, x = near_one(LONG_SCANS[0], g)
        exact = scan_f64(a, x)
        got = ls_ops.linear_scan(a, x, bs=256)
        err = (got.double() - exact).abs().max().item()
        err_plain = (ls_ref.linear_scan(a, x).double()
                     - exact).abs().max().item()
        nearer.append(err <= err_plain)
        print(f"[scan] linear_scan {LONG_SCANS[0]} a in (0.999, 1], seed "
              f"{seed}: the kernel {err:.3e}, the f32 loop {err_plain:.3e} "
              f"from the float64 recurrence")
    print(f"[scan] the kernel no farther from the float64 recurrence than "
          f"the f32 loop on {sum(nearer)} of {SCAN_SEEDS} seeds")
    del a, x, exact, got
    scan_times = {}
    for dname in ("float32", "bfloat16"):
        dt = dtypes[dname]
        label = f"linear_scan RG-LRU {FULL_SCAN} {dname}"
        a, x = decay(FULL_SCAN, dt), rand(FULL_SCAN, dt)

        def run(a=a, x=x):
            return ls_ops.linear_scan(a, x)

        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        path_counts[label] = counts()
        only(label, path_counts[label], "linear_scan", 1)
        path = ls_ops.route(dt, FULL_SCAN[2], (a.data_ptr(), x.data_ptr()))
        check(ls_ops.linear_scan.routes == {path: 1},
              f"{label}: launches by route {ls_ops.linear_scan.routes}")
        err = scan_compare(label, got, ls_ref.linear_scan(a, x), dname)
        scan_bits(label, got, a, x)
        del got
        # device time: the memset and the kernel of each call, back to back
        # in a CUDA graph (no host time between calls), the better of two
        # graphs: the first graph timed after the plain loops has run
        # slower once in f32, by about 15%, where the profiler showed the
        # kernel at its usual time
        graphs = [graph_ms(torch, run) for _ in range(2)]
        ms = min(graphs)
        a_odd, x_odd = odd_offset(a), odd_offset(x)
        ms_ldg = min(graph_ms(torch, lambda: ls_ops.linear_scan(a_odd, x_odd))
                     for _ in range(2))
        y = torch.empty_like(x)
        add_ms = min(graph_ms(torch, lambda: torch.add(a, x, out=y))
                     for _ in range(2))
        clocks = gpu_clocks()
        plain = time_ms(torch, lambda a=a, x=x: ls_ref.linear_scan(a, x),
                        iters=2, warmup=1)
        nbytes = 3 * a.numel() * a.element_size()
        bnd, by = bound_ms(nbytes, 2 * a.numel(), dname)
        print(f"[scan] {label}: first call {wall * 1e3:.3f} ms wall; kernel "
              f"({path}) {ms:.4f} ms (graphs {graphs[0]:.4f}, "
              f"{graphs[1]:.4f}; {nbytes / ms / 1e6:.1f} GB/s of the "
              f"bound's bytes, {bnd / ms:.3f} of the bound), on the ldg "
              f"route (odd offset) {ms_ldg:.4f} ms; torch.add(a, x, out=y), "
              f"the card's rate for the same 3 S D elements (a yardstick, "
              f"not the same function) {add_ms:.4f} ms; plain {plain:.3f} "
              f"ms; no single-call library counterpart; bound {bnd:.4f} ms "
              f"({by}, {nbytes / 1e6:.1f} MB); clocks (SM, memory) after "
              f"the timings: {clocks}")
        scan_times[dname] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                 bound_ms=bnd, bound_by=by, library_ms=None)
        device_profile(torch, label, run, warm_wall(run),
                       {"linear_scan_kernel": 1,
                        "linear_scan_chunk_kernel": 0,
                        "linear_scan_carry_kernel": 0,
                        "linear_scan_apply_kernel": 0})
        del a, x, run, a_odd, x_odd, y

    lap("[scan]")

    # -- 5-6. Listing 1 and Strassen, serial -------------------------------------
    n = N_LISTING
    A = torch.randn((n, n), generator=gen, device=dev)
    B = torch.randn((n, n), generator=gen, device=dev)
    exact = A.double() @ B.double()
    exact_norm = torch.linalg.norm(exact).item()
    nt = n // IB
    flops = 2 * n ** 3

    def rel_err(C):
        return (torch.linalg.norm(C.double() - exact).item() / exact_norm)

    def listing1(backend="serial"):
        C, stats, _ = run_distributed_gemm(A, B, ib=IB, NP=2, NQ=2,
                                           device=dev, backend=backend)
        return C, stats

    def strassen(backend="serial"):
        ex = bind.LocalExecutor(1, backend=backend)
        with bind.Workflow(executor=ex) as wf:
            ta = Tiled.from_array(wf, A, IB, "A")
            tb = Tiled.from_array(wf, B, IB, "B")
            tc = Tiled.zeros(wf, nt, nt, IB, torch.float32, "C", device=dev)
            gemm_strassen(ta, tb, tc)
            C = tc.to_array()
        return C, ex.stats

    # Strassen on an nt x nt grid (nt a power of two) has 7^log2(nt) leaves
    paths = {"listing1": (listing1, "gemm.matmul", nt ** 3, 1e-4),
             "strassen": (strassen, "gemm.matmul_accumulate",
                          7 ** (nt.bit_length() - 1), 1e-3)}
    serial = {}             # path -> (C, transfers) of the serial warm run
    serial_busy = {}        # path -> the serial warm run's busy share (%)
    for path, (run, wrapper, want, tol) in paths.items():
        def describe(phase, result, got, wall, mallocs, path=path,
                     wrapper=wrapper, want=want, tol=tol):
            C, stats = result
            err = rel_err(C)
            print(f"[{path}] {phase}: n={n} ib={IB} float32 serial: wall "
                  f"{wall:.4f} s ({flops / wall / 1e12:.3f} TFLOP/s"
                  f"{' classical-equivalent' if path == 'strassen' else ''})"
                  f", rel_err {err:.3e}, {wrapper} launches {got[wrapper]}, "
                  f"ops {stats.ops_executed}, messages {stats.message_count}"
                  f", bytes {stats.bytes_transferred}, wavefronts "
                  f"{len(stats.wavefronts)}, peak live bytes "
                  f"{stats.peak_live_bytes}, cudaMalloc calls {mallocs}")
            check(tuple(C.shape) == (n, n) and C.dtype == torch.float32,
                  f"{path}: result {C.dtype}{tuple(C.shape)}")
            check(bool(torch.isfinite(C).all()), f"{path}: non-finite values")
            check(err <= tol, f"{path}: relative error {err} > {tol}")
            only(path, got, wrapper, want)
            routes = dict(wrappers[wrapper].routes)
            check(routes == {F32_ROUTE: want}, f"{path}: {wrapper} launches "
                  f"by route {routes}, expected {want} on {F32_ROUTE}")

        transfers = []
        C, got, walls = measured(
            path, run, describe,
            keep=lambda r, t=transfers: t.extend(r[1].transfers) or r[0])
        path_counts[path] = got
        serial_busy[path] = device_profile(torch, path, run, walls["warm"],
                                           {F32_KERNEL: want})
        serial[path] = (C, transfers)
        del C

    lap("[listing1] [strassen] serial")

    # -- 7. the chain path through the engine -------------------------------
    L = SCAN_LEVELS
    Y0 = rand((IB, IB), torch.float32)
    X0 = rand((IB, IB), torch.float32)
    XL = [rand((IB, IB), torch.float32) for _ in range(L)]
    C0 = rand((IB, IB), torch.float32)
    AL = [rand((IB, IB), torch.float32) for _ in range(DOT_LEVELS)]
    BL = [rand((IB, IB), torch.float32) for _ in range(DOT_LEVELS)]
    m, n, d, dv = ATTN_TILE
    O0 = rand((m, dv), torch.float32)
    QA = rand((m, d), torch.float32)
    KL = [rand((n, d), torch.float32) for _ in range(ATTN_LEVELS)]
    VL = [rand((n, dv), torch.float32) for _ in range(ATTN_LEVELS)]

    # the same chains in float16: each input rounded to it
    H = {name: (t.half() if isinstance(t, torch.Tensor)
                else [x.half() for x in t])
         for name, t in (("Y0", Y0), ("X0", X0), ("XL", XL), ("C0", C0),
                         ("AL", AL), ("BL", BL), ("O0", O0), ("QA", QA),
                         ("KL", KL), ("VL", VL))}
    F = dict(Y0=Y0, X0=X0, XL=XL, C0=C0, AL=AL, BL=BL, O0=O0, QA=QA, KL=KL,
             VL=VL)

    def scan_chain(backend, fresh_x, src=F):
        ex = bind.LocalExecutor(1, mode="plan", backend=backend)
        with bind.Workflow(executor=ex) as wf:
            y = wf.array(src["Y0"], "y")
            x = wf.array(src["X0"], "x")
            for level in range(L):
                if fresh_x:
                    x = wf.array(src["XL"][level], f"x{level}")
                wf.call(scan_step, (y, 0.5, x), name="scan_step")
            out = wf.fetch(y)
        return out, ex.backend

    def gemm_chain(backend, src=F):
        ex = bind.LocalExecutor(1, mode="plan", backend=backend)
        with bind.Workflow(executor=ex) as wf:
            c = wf.array(src["C0"], "c")
            for level in range(DOT_LEVELS):
                a = wf.array(src["AL"][level], f"a{level}")
                b = wf.array(src["BL"][level], f"b{level}")
                wf.call(gemm_tile, (c, a, b), name="gemm_tile")
            out = wf.fetch(c)
        return out, ex.backend

    def attn_chain(backend, src=F):
        ex = bind.LocalExecutor(1, mode="plan", backend=backend)
        with bind.Workflow(executor=ex) as wf:
            o = wf.array(src["O0"], "o")
            q = wf.array(src["QA"], "q")
            for level in range(ATTN_LEVELS):
                k = wf.array(src["KL"][level], f"k{level}")
                v = wf.array(src["VL"][level], f"v{level}")
                wf.call(attn_step, (o, q, k, v), name="attn_step")
            out = wf.fetch(o)
        return out, ex.backend

    # label -> (run, wrapper, levels, kernel, chain_dot's or chain_attn's
    # route)
    chains = {
        "scan chain, x single": (lambda b: scan_chain(b, False),
                                 "chain.ewise", L, "chain_ewise_kernel",
                                 None),
        "scan chain, x per level": (lambda b: scan_chain(b, True),
                                    "chain.ewise", L, "chain_ewise_kernel",
                                    None),
        "gemm_tile chain": (gemm_chain, "chain.dot", DOT_LEVELS,
                            "chain_dot_tf32_kernel", F32_ROUTE),
        "attn_step chain": (attn_chain, "chain.attn", ATTN_LEVELS,
                            "chain_attn_tf32_kernel", "f32_3xtf32"),
        "scan chain f16, x single": (lambda b: scan_chain(b, False, H),
                                     "chain.ewise", L, "chain_ewise_kernel",
                                     None),
        "scan chain f16, x per level": (lambda b: scan_chain(b, True, H),
                                        "chain.ewise", L,
                                        "chain_ewise_kernel", None),
        "gemm_tile chain f16": (lambda b: gemm_chain(b, H), "chain.dot",
                                DOT_LEVELS, "chain_dot_wgmma_kernel",
                                "f16_wgmma"),
        "attn_step chain f16": (lambda b: attn_chain(b, H), "chain.attn",
                                ATTN_LEVELS, "chain_attn_wgmma_kernel",
                                "f16_wgmma"),
    }
    for label, (run, wrapper, levels, kernel_name, dot_path) in \
            chains.items():
        serial_walls = []           # cold (first plan of this shape), warm
        for _ in range(2):
            zero_counts()
            t0 = time.perf_counter()
            want, _ = run("serial")
            torch.cuda.synchronize()
            serial_walls.append(time.perf_counter() - t0)
        serial_wall = serial_walls[1]
        serial_counts = counts()
        check(not any(serial_counts[name] for name in bodies),
              f"{label}: serial replay took a body expression: "
              f"{serial_counts}")

        def describe(phase, result, got, wall, mallocs, label=label,
                     wrapper=wrapper, levels=levels, want=want,
                     dot_path=dot_path):
            out, mb = result
            print(f"[chains] {label} {phase}: mesh wall {wall * 1e3:.3f} ms "
                  f"(serial warm {serial_wall * 1e3:.3f} ms), "
                  f"pallas_chains_dispatched {mb.pallas_chains_dispatched}, "
                  f"ops_pallas {mb.ops_pallas}, chains_dispatched "
                  f"{mb.chains_dispatched}, launches {got}, cudaMalloc calls "
                  f"{mallocs}")
            same_bits(f"{label} {phase}: mesh vs serial", out, want)
            check(mb.pallas_chains_dispatched == 1 and mb.ops_pallas == levels,
                  f"{label}: {mb.pallas_chains_dispatched} chain dispatches, "
                  f"{mb.ops_pallas} ops, expected 1 and {levels}")
            only(label, got, wrapper, 1)
            if wrapper in ("chain.dot", "chain.attn"):
                routes = wrappers[wrapper].routes
                check(routes == {dot_path: 1}, f"{label}: {wrapper} by "
                      f"route {routes}, expected {dot_path}")

        def mesh_run(run=run):
            return run(bind.MeshBackend(pallas=True))

        _kept, got, walls = measured(label, mesh_run, describe)
        del want
        path_counts[label] = got
        # a chain_attn launch of several levels is its chain kernel and the
        # kernel that folds the levels into the carry after it
        expect = {kernel_name: 1, **{name: 0 for name in GEMM_KERNELS},
                  **({"chain_attn_fold_kernel": 1}
                     if wrapper == "chain.attn" else {})}
        busy = device_profile(torch, label, mesh_run, walls["warm"], expect)
        print(f"[chains] {label}: serial replay launched {serial_counts}, "
              f"walls cold {serial_walls[0] * 1e3:.3f} ms warm "
              f"{serial_walls[1] * 1e3:.3f} ms; mesh walls cold "
              f"{walls['cold'] * 1e3:.3f} ms warm {walls['warm'] * 1e3:.3f} "
              f"ms, busy {busy:.1f}%")
        lap(f"[chains] {label}")

    # -- 7b. the rank mesh: ships as ppermute rounds, pallas="auto" --------
    t0 = time.perf_counter()
    mesh = mesh_phase(
        torch, dev, bind, A, B, serial["listing1"][0], card, same_bits, only,
        measured, {label: chains[label][:3] for label in
                   ("scan chain, x per level", "gemm_tile chain")})
    print(f"[time] [mesh]: {time.perf_counter() - t0:.1f} s")
    lap()
    del Y0, X0, XL, C0, AL, BL, O0, QA, KL, VL, F, H

    # -- 8. Listing 1 and Strassen under fused and threads ---------------------
    for backend in ("fused", "threads"):
        for path, (run, wrapper, want, tol) in paths.items():
            C_serial, transfers = serial[path]
            label = f"{path} {backend}"
            seen = {}

            def traced(run=run, backend=backend, seen=seen):
                ex_backend = bind.get_backend(backend)
                seen["backend"] = ex_backend
                return run(ex_backend)

            def describe(phase, result, got, wall, mallocs, label=label,
                         wrapper=wrapper, want=want, C_serial=C_serial,
                         transfers=transfers, seen=seen):
                C, stats = result
                bk = seen["backend"]
                extra = (f"batches_dispatched {bk.batches_dispatched}, "
                         f"ops_fused {bk.ops_fused}, chains_dispatched "
                         f"{bk.chains_dispatched}, ops_chained "
                         f"{bk.ops_chained}" if backend == "fused" else
                         f"pooled_levels {bk.pooled_levels}, inlined_levels "
                         f"{bk.inlined_levels}, plans_delegated "
                         f"{bk.plans_delegated}")
                print(f"[{label}] {phase}: wall {wall:.4f} s "
                      f"({flops / wall / 1e12:.3f} TFLOP/s), {wrapper} "
                      f"launches {got[wrapper]}, {extra}, peak live bytes "
                      f"{stats.peak_live_bytes}, cudaMalloc calls {mallocs}")
                same_bits(f"{label} {phase}: C vs serial", C, C_serial)
                check(list(stats.transfers) == transfers,
                      f"{label}: transfer stream differs from serial")
                only(label, got, wrapper, want)
                routes = dict(wrappers[wrapper].routes)
                check(routes == {F32_ROUTE: want}, f"{label}: {wrapper} "
                      f"launches by route {routes}, expected {want} on "
                      f"{F32_ROUTE}")

            _kept, got, walls = measured(label, traced, describe)
            busy = device_profile(torch, label, traced, walls["warm"],
                                  {F32_KERNEL: want})
            print(f"[{label}] walls cold {walls['cold']:.4f} s warm "
                  f"{walls['warm']:.4f} s, busy {busy:.1f}%")
    # the reference's bar (benchmarks/bench_dag_overhead.py): threads at
    # least 0.9x serial, held on CUDA tiles over THREADS_ROUNDS interleaved
    # warm rounds, the side that goes first alternating from round to
    # round, each run after a cyclic collection, so that neither side pays
    # for one that the other's garbage set off.  Host walls of one run
    # swing by tens of per cent from round to round, more than the gap
    # between two sides that run the same serial plan loop, and the best
    # of each side is one lucky sample: on one tree it read 0.78 to 1.07.
    # So the bar holds the median over rounds of serial's wall over
    # threads', the two runs of a round back to back on the same host
    # state; each side's best is printed beside it.  The heap the script
    # has built so far is frozen out of the collector for the bar, so a
    # collection walks only what the runs left, not the whole heap
    gc.collect()
    gc.freeze()
    try:
        for path, (run, wrapper, want, tol) in paths.items():
            walls = {"serial": [], "threads": []}
            delegated = 0
            for round_ in range(THREADS_ROUNDS):
                for backend in (("serial", "threads"), ("threads", "serial")
                                )[round_ % 2]:
                    ex_backend = bind.get_backend(backend)
                    gc.collect()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    result = run(ex_backend)
                    torch.cuda.synchronize()
                    walls[backend].append(time.perf_counter() - t0)
                    if backend == "threads":
                        delegated += ex_backend.plans_delegated
                    del result
            pairs = sorted(s / t for s, t in zip(walls["serial"],
                                                 walls["threads"]))
            ratio = statistics.median(pairs)
            best = {k: min(v) for k, v in walls.items()}
            print(f"[threads] {path}: {THREADS_ROUNDS} interleaved warm "
                  f"rounds (first side alternating, collected before each): "
                  f"serial's wall over threads' median {ratio:.3f} (bar 0.9; "
                  f"quartiles {pairs[len(pairs) // 4]:.3f} / "
                  f"{pairs[3 * len(pairs) // 4]:.3f}), medians serial "
                  f"{statistics.median(walls['serial']):.4f} s, threads "
                  f"{statistics.median(walls['threads']):.4f} s, best "
                  f"serial {best['serial']:.4f} s, threads "
                  f"{best['threads']:.4f} s "
                  f"({best['serial'] / best['threads']:.3f}), plans "
                  f"delegated to serial {delegated} of {THREADS_ROUNDS}")
            check(ratio >= 0.9, f"{path}: threads at {ratio:.3f} x serial, "
                  f"below the reference's 0.9")
    finally:
        gc.unfreeze()

    lap("[listing1] [strassen] fused, threads")

    # -- 8-f16. Listing 1 in float16 on serial, fused and threads -------------
    # A and B rounded to float16: every leaf product on f16_wgmma, C bit for
    # bit across the backends, within F16_LISTING_REL of the float64
    # product of the same float16 inputs; serial's warm run profiled
    A16, B16 = A.half(), B.half()
    exact16 = A16.double() @ B16.double()
    exact16_norm = torch.linalg.norm(exact16).item()
    leaves = (N_LISTING // IB) ** 3
    listing_f16 = {}
    for backend in ("serial", "fused", "threads"):
        label = f"listing1 f16 {backend}"

        def run(backend=backend):
            C, stats, _ = run_distributed_gemm(A16, B16, ib=IB, NP=2, NQ=2,
                                               device=dev, backend=backend)
            return C, stats

        def describe(phase, result, got, wall, mallocs, label=label,
                     backend=backend):
            C, stats = result
            err = (torch.linalg.norm(C.double() - exact16).item()
                   / exact16_norm)
            print(f"[{label}] {phase}: n={N_LISTING} ib={IB} float16: wall "
                  f"{wall:.4f} s ({2 * N_LISTING ** 3 / wall / 1e12:.3f} "
                  f"TFLOP/s), rel_err {err:.3e} (limit {F16_LISTING_REL}), "
                  f"gemm.matmul launches {got['gemm.matmul']} by route "
                  f"{ops.matmul.routes}, ops {stats.ops_executed}, peak live "
                  f"bytes {stats.peak_live_bytes}, cudaMalloc calls "
                  f"{mallocs}")
            check(tuple(C.shape) == (N_LISTING, N_LISTING)
                  and C.dtype == torch.float16,
                  f"{label}: result {C.dtype}{tuple(C.shape)}")
            check(bool(torch.isfinite(C).all()), f"{label}: non-finite "
                  f"values")
            check(err <= F16_LISTING_REL, f"{label}: relative error {err} > "
                  f"{F16_LISTING_REL}")
            only(label, got, "gemm.matmul", leaves)
            check(ops.matmul.routes == {"f16_wgmma": leaves}, f"{label}: "
                  f"gemm.matmul launches by route {ops.matmul.routes}, "
                  f"expected {leaves} on f16_wgmma")
            if backend != "serial":
                same_bits(f"{label} {phase}: C vs serial", C,
                          listing_f16["serial"]["C"])
            listing_f16.setdefault(backend, {})["rel_err"] = err

        C, got, walls = measured(label, run, describe,
                                 keep=lambda r, b=backend: r[0]
                                 if b == "serial" else None)
        listing_f16[backend].update(walls_s=walls, launches=got["gemm.matmul"])
        if backend == "serial":
            listing_f16["serial"]["C"] = C
            path_counts[label] = got
            found = {}
            busy = device_profile(torch, label, run, walls["warm"],
                                  {"gemm_wgmma_kernel": leaves}, found)
            listing_f16["serial"].update(
                busy_pct=busy, gemm_ms=found["gemm_wgmma_kernel"][0],
                device_ms=found["total"])
        print(f"[{label}] walls cold {walls['cold']:.4f} s warm "
              f"{walls['warm']:.4f} s; C bit for bit across the backends so "
              f"far")
    del A16, B16, exact16, C, listing_f16["serial"]["C"]

    lap("[listing1 f16]")

    # -- 8a. Listing 1 on the process pool, and under faults -------------------
    t0 = time.perf_counter()
    procs = procs_phase(torch, dev, bind, A, B, card, same_bits, zero_counts,
                        serial_busy["listing1"])
    print(f"[time] [procs]: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    faults = faults_phase(torch, dev, bind, A, B, procs.pop("C"), card,
                          same_bits)
    print(f"[time] [faults]: {time.perf_counter() - t0:.1f} s")
    lap()

    # -- 8b. tensor bodies on operands their kernels do not take ------------
    gi = torch.randint(-9, 9, (64, 64), generator=gen, device=dev,
                       dtype=torch.int32)
    gi = (gi, gi.flip(0).contiguous(), gi.flip(1).contiguous())
    # exact in int64 on the host (the card has no integer matrix product)
    exact = (gi[0].cpu().long() + gi[1].cpu().long() @ gi[2].cpu().long()
             ).to(torch.int32).to(dev)
    mixed = (rand((64, 64), torch.float32), rand((64, 64), torch.float16),
             rand((64, 64), torch.float16))
    mixed_exp = mixed[0] + (mixed[1] @ mixed[2])
    o3, q3 = rand((2, 64, 32), torch.float32), rand((2, 64, 16),
                                                    torch.float32)
    k2, v2 = rand((48, 16), torch.float32), rand((48, 32), torch.float32)
    half = tuple(t.to(torch.float16) for t in (o3[0], q3[0], k2, v2))
    # float16 with dv past the chain kernel's 256 (its v and o 264 wide)
    wide = (rand((64, 264), torch.float16), half[1], half[2],
            rand((48, 264), torch.float16))

    def step_expr(o, q, k, v):
        # the reference's attn_step body, written out
        sc = torch.softmax((q @ k.T) * (1.0 / float(q.shape[-1]) ** 0.5), -1)
        return o + sc @ v

    rejected = (
        ("gemm_tile int32", gemm_tile, gi, exact, 0.0, "body.gemm"),
        ("_t_gemm_acc int32", tiles_ops._t_gemm_acc, gi, exact, 0.0,
         "body.gemm"),
        ("gemm_tile f32 c, f16 a b", gemm_tile, mixed, mixed_exp, 1e-6,
         "body.gemm"),
        ("attn_step 3-D o, q", attn_step, (o3, q3, k2, v2),
         step_expr(o3, q3, k2, v2), 1e-6, "body.attn"),
        ("attn_step float16 dv 264", attn_step, wide, step_expr(*wide),
         1e-3, "body.attn"))
    for label, body, args, exp, tol, expr in rejected:
        zero_counts()
        got = body(*args)
        torch.cuda.synchronize()
        launched = {k: v for k, v in counts().items() if v}
        check(launched == {expr: 1}, f"{label}: counted {launched}, "
              f"expected one {expr} call and no kernel launch")
        check(got.dtype == exp.dtype and got.shape == exp.shape
              and got.device == exp.device,
              f"{label}: {got.dtype}{tuple(got.shape)} on {got.device}, "
              f"expected {exp.dtype}{tuple(exp.shape)} on {exp.device}")
        err = (got.double() - exp.double()).abs().max().item()
        check(err <= tol * max(1.0, exp.double().abs().max().item()),
              f"{label}: max_abs_err {err:.3e}")
        print(f"[bodies] {label} on the card: no kernel launch, one "
              f"{expr} call, "
              f"{got.dtype}{tuple(got.shape)}, max_abs_err {err:.3e} against "
              f"the reference's body expression: ok")
    # float16 tiles the chain kernel takes: one chain_attn launch (one
    # level), no body expression, within TOL["float16"] of the plain
    # version (float32 inside, one rounding); the body expression, which
    # rounds to float16 after each operator, printed beside it.  At d 16
    # the CUDA-core loop takes them, at d = dv = 64 (and in bfloat16 there)
    # the tensor cores
    o64, q64 = rand((64, 64), torch.float32), rand((64, 64), torch.float32)
    k64, v64 = rand((48, 64), torch.float32), rand((48, 64), torch.float32)
    taken = (("float16", half, "f16_simt"),
             ("float16 d 64", tuple(t.half() for t in (o64, q64, k64, v64)),
              "f16_wgmma"),
             ("bfloat16 d 64",
              tuple(t.bfloat16() for t in (o64, q64, k64, v64)),
              "bf16_wgmma"))
    for label, args, route in taken:
        zero_counts()
        got = attn_step(*args)
        torch.cuda.synchronize()
        launched = {k: v for k, v in counts().items() if v}
        check(launched == {"chain.attn": 1}, f"attn_step {label}: counted "
              f"{launched}, expected one chain.attn launch")
        check(chain_ops.chain_attn.routes == {route: 1}, f"attn_step "
              f"{label}: routes {chain_ops.chain_attn.routes}, expected "
              f"{route}")
        dname = str(args[0].dtype).removeprefix("torch.")
        err = close("bodies", f"attn_step {label} [chain.attn, {route}]", got,
                    fa_ref.attn_step(*args), *TOL[dname])
        body_err = (got.double() - step_expr(*args).double()).abs().max(
            ).item()
        print(f"[bodies] attn_step {label} on the card: one chain.attn "
              f"launch on {route}, no body expression; max_abs_err "
              f"{err:.3e} against the plain version, {body_err:.3e} against "
              f"the reference's body expression in {dname}")
    del o64, q64, k64, v64, taken, args
    del gi, exact, mixed, mixed_exp, o3, q3, k2, v2, half, wide, got
    print(f"[memory] peak allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB")

    lap("[bodies]")

    # -- 8c. the serving runtime on the card -----------------------------------
    @bind.op
    def decode_step(x: bind.InOut, s: bind.In):
        # bench_serving.py's decode step
        return x * 0.99 + s

    @bind.op
    def guard(x: bind.InOut):
        # quickstart section 11's poison check
        if float(torch.min(x)) < 0:
            raise ValueError("negative activation")
        return x

    f32 = torch.float32
    sq_rows, skv, d_head, dv_head = ATTN_TILE
    serve_a, serve_b = rand((IB, IB), f32), rand((IB, IB), f32)
    serve_init = [{"c": rand((IB, IB), f32), "o": rand((sq_rows, dv_head), f32),
                   "q": rand((sq_rows, d_head), f32), "x": rand((IB, IB), f32)}
                  for _ in range(SERVE_SESSIONS)]
    n_requests = SERVE_SESSIONS * (1 + SERVE_STEPS)
    n_kernel_steps = SERVE_SESSIONS * SERVE_STEPS

    def kv_stream(i):
        """Session ``i``'s fresh k and v for each step, made on the card by
        whoever iterates (its client thread), the same in every run."""
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 1000 + i)
        for _ in range(SERVE_STEPS):
            yield (torch.randn((skv, d_head), generator=g, device=dev),
                   torch.randn((skv, dv_head), generator=g, device=dev))

    def init_state(make, i):
        # A and B are the same two tensors in every session
        return {"a": make(serve_a, "a"), "b": make(serve_b, "b"),
                **{name: make(t, name) for name, t in serve_init[i].items()}}

    def record_step(make, st, k, v):
        """One served step: Listing 1's tile accumulate (the GEMM), one
        attention block on a Qwen3-14B head's query tile (chain_attn, one
        level) and the decode step; returns the session's C, carry and
        state."""
        wf = bind.current_workflow()
        wf.call(gemm_tile, (st["c"], st["a"], st["b"]), name="gemm_tile")
        wf.call(attn_step, (st["o"], st["q"], make(k, "k"), make(v, "v")),
                name="attn_step")
        decode_step(st["x"], 0.5)
        return st["c"], st["o"], st["x"]

    # the same steps recorded into one workflow, run by a serial executor
    zero_counts()
    ex = bind.LocalExecutor(1, backend="serial")
    with bind.Workflow(executor=ex) as wf:
        states = [init_state(wf.array, i) for i in range(SERVE_SESSIONS)]
        streams = [kv_stream(i) for i in range(SERVE_SESSIONS)]
        for _ in range(SERVE_STEPS):
            for i in range(SERVE_SESSIONS):
                k, v = next(streams[i])
                record_step(wf.array, states[i], k, v)
        serve_want = [tuple(wf.fetch(st[name]) for name in ("c", "o", "x"))
                      for st in states]
    torch.cuda.synchronize()
    got = counts()
    check(got["gemm.matmul_accumulate"] == n_kernel_steps
          and got["chain.attn"] == n_kernel_steps,
          f"serve reference: launches {got}")
    del ex, wf, states, streams, k, v

    def serve_arm(backend, max_batch):
        """8 lock-step clients (bench_serving.py's shape) against one
        runtime: each opens a session, sends one init request, waits for
        all, then sends its steps one at a time, copying each result to the
        host before the next.  Returns what the checks and the lines need."""
        rt = ServingRuntime(n_nodes=1, backend=backend, max_batch=max_batch)
        barrier = threading.Barrier(SERVE_SESSIONS)
        waits = bind.LatencyStats()
        lock = threading.Lock()

        def client(i):
            sess = rt.session()

            def init(s):
                s.state.update(init_state(s.array, i))

            sess.submit(init).result(timeout=300)
            barrier.wait(timeout=300)
            result = None
            for k, v in kv_stream(i):
                t0 = time.perf_counter()
                fut = sess.submit(
                    lambda s, k=k, v=v: record_step(s.array, s.state, k, v))
                result = fut.result(timeout=300)
                for t in result:
                    t.cpu()
                with lock:
                    waits.record(time.perf_counter() - t0)
            return result

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_SESSIONS) as pool:
            finals = list(pool.map(client, range(SERVE_SESSIONS)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bk = rt.executor.backend
        out = {"finals": finals, "wall": wall, "waits": waits,
               "metrics": rt.metrics, "backend": bk}
        rt.close()
        return out

    def same_finals(label, finals):
        for i, (want, final) in enumerate(zip(serve_want, finals)):
            for name, w, g in zip(("C", "carry", "state"), want, final):
                same_bits(f"{label}: session {i} {name} vs the serial "
                          f"workflow", g, w)

    for backend in ("serial", "fused", "threads"):
        for max_batch in (1, 8):
            label = f"serve {backend} max_batch={max_batch}"
            for phase in ("cold", "warm"):
                zero_counts()
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated(dev)
                arm = serve_arm(backend, max_batch)
                got = counts()
                m, bk = arm["metrics"], arm["backend"]
                same_finals(f"{label} {phase}", arm["finals"])
                launched = {k: v for k, v in got.items() if v}
                check(launched == {"gemm.matmul_accumulate": n_kernel_steps,
                                   "chain.attn": n_kernel_steps},
                      f"{label}: launches {launched}, expected "
                      f"{n_kernel_steps} GEMM and {n_kernel_steps} chain_attn "
                      f"launches, no other kernel and no body expression")
                routes = dict(ops.matmul_accumulate.routes)
                check(routes == {F32_ROUTE: n_kernel_steps}, f"{label}: "
                      f"GEMM launches by route {routes}, expected "
                      f"{n_kernel_steps} on {F32_ROUTE}")
                # each served attn_step one chain_attn launch of one level
                # on the 3xTF32 route, its keys in chunks
                routes = dict(chain_ops.chain_attn.routes)
                check(routes == {F32_ROUTE: n_kernel_steps}, f"{label}: "
                      f"chain_attn launches by route {routes}, expected "
                      f"{n_kernel_steps} on {F32_ROUTE}")
                check(m.requests_completed == n_requests
                      and m.requests_failed == 0,
                      f"{label}: {m.requests_completed} requests completed, "
                      f"{m.requests_failed} failed")
                # one request's three ops differ in signature: only requests
                # flushed together give the fused backend ops to stack
                if max_batch > 1:
                    check(m.coalesced_requests > 0,
                          f"{label}: no request coalesced")
                    check(backend != "fused" or bk.ops_fused > 0,
                          f"{label}: no op fused")
                extra = (f"batches_dispatched {bk.batches_dispatched}, "
                         f"ops_fused {bk.ops_fused}" if backend == "fused"
                         else f"plans_delegated {bk.plans_delegated}"
                         if backend == "threads" else "")
                lat, waits = m.latency, arm["waits"]
                wall = arm["wall"]
                print(f"[serve] {label} {phase}: {n_requests} requests in "
                      f"{wall:.4f} s ({n_requests / wall:.1f} requests/s); "
                      f"runtime latency (submit to enqueue) p50 "
                      f"{lat.p50 * 1e3:.3f} ms p99 {lat.p99 * 1e3:.3f} ms; "
                      f"clients' wait to a host copy p50 "
                      f"{waits.p50 * 1e3:.3f} ms p99 {waits.p99 * 1e3:.3f} "
                      f"ms; flushes {m.flushes}, batched_flushes "
                      f"{m.batched_flushes}, coalesced_requests "
                      f"{m.coalesced_requests}, max_batch {m.max_batch}"
                      + (f", {extra}" if extra else "")
                      + f"; GEMM launches {got['gemm.matmul_accumulate']}, "
                      f"chain_attn launches {got['chain.attn']}; bitwise the "
                      f"serial workflow")
                del arm, m, bk, lat, waits
                freed(label, base)
            busy = device_profile(
                torch, label, lambda b=backend, mb=max_batch: serve_arm(b, mb),
                wall, SERVE_KERNELS)
            print(f"[serve] {label}: warm wall {wall:.4f} s, busy {busy:.1f}%")

        # quickstart section 11 on CUDA payloads: shedding and bisection
        zero_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        one = torch.full((IB, IB), 1.0, device=dev) * 0.99 + 0.5
        with ServingRuntime(n_nodes=1, backend=backend, autostart=False,
                            max_queue=2, compact_threshold=8) as rt:
            def step_for(value):
                def step(s):
                    x = s.state.get("x")
                    if x is None:
                        x = s.state["x"] = s.array(
                            torch.full((IB, IB), value, device=dev), name="x")
                    guard(x)
                    decode_step(x, 0.5)
                    return x
                return step

            sessions = [rt.session() for _ in range(3)]
            futs = [sessions[0].submit(step_for(1.0)),
                    sessions[1].submit(step_for(-1.0))]   # the poison pill
            try:
                sessions[2].submit(step_for(3.0))
                fail(f"serve {backend}: a full queue took a third request")
            except RuntimeOverloaded:
                pass
            rt.start()
            same_bits(f"serve {backend} overload: salvaged request",
                      futs[0].result(timeout=60), one)
            try:
                futs[1].result(timeout=60)
                fail(f"serve {backend}: the poison pill succeeded")
            except ValueError:
                pass
            check(sessions[1].poisoned is not None
                  and sessions[0].poisoned is None
                  and sessions[2].poisoned is None,
                  f"serve {backend}: poisoned {sessions}")
            try:
                sessions[1].submit(step_for(1.0))
                fail(f"serve {backend}: a poisoned session took a request")
            except SessionPoisoned:
                pass
            m = rt.metrics
            check(m.requests_shed == 1 and m.bisections == 1
                  and m.requests_salvaged == 1 and m.requests_completed == 1,
                  f"serve {backend} overload: {m.summary()}")
            print(f"[serve] {backend} overload: {m.requests_shed} shed, "
                  f"{m.bisections} bisection x {m.bisect_probes} probes "
                  f"salvaged {m.requests_salvaged}; session 1 alone poisoned")
        del rt, sessions, futs, m, one
        # the poison pill's exception holds, through its traceback's frames,
        # the batch that raised it, whose futures hold the exception: the
        # reference's runtime does the same (ROADMAP Queue 3), so the
        # failed batch and its runtime go at the next cyclic collection
        held = torch.cuda.memory_allocated(dev) - base
        gc.collect()
        print(f"[serve] {backend} overload: {held} bytes held by the failed "
              f"batch's traceback cycle until gc.collect()")
        freed(f"serve {backend} overload", base)

        # bench_serving.py's steady state: one session, 100 decode steps
        steady = rand((IB, IB), f32)
        want = steady
        for _ in range(100):
            want = want * 0.99 + 0.5
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        sizes = []
        t0 = time.perf_counter()
        with ServingRuntime(n_nodes=1, backend=backend, admission_window=0.0,
                            compact_threshold=12) as rt:
            s = rt.session()

            def step(sess):
                if "x" not in sess.state:
                    sess.state["x"] = sess.array(steady, name="x")
                decode_step(sess.state["x"], 0.5)
                return sess.state["x"]

            for _ in range(100):
                got = s.submit(step).result(timeout=60)
                sizes.append(len(rt._wf.ops))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            same_bits(f"serve {backend} steady state", got, want)
            m = rt.metrics
            check(max(sizes) <= 12 and m.trace_ops_hwm <= 12
                  and m.compactions > 0,
                  f"serve {backend} steady state: trace sizes up to "
                  f"{max(sizes)}, {m.summary()}")
            print(f"[serve] {backend} steady state: 100 steps in "
                  f"{wall:.4f} s, trace_ops_hwm {m.trace_ops_hwm} (bound 12), "
                  f"{m.compactions} compactions, {m.ops_compacted} ops "
                  f"compacted; bitwise 100 eager steps")
        del rt, s, got, m, steady, want
        freed(f"serve {backend} steady state", base)
    del serve_a, serve_b, serve_init, serve_want

    lap("[serve]")

    # -- 8d. MapReduce: sorting integers on the card and on the host -----------
    keys = torch.randint(0, 2 ** 31 - 1, (SORT_N,), generator=gen,
                         device=dev, dtype=torch.int64)
    keys_sorted = torch.sort(keys).values
    for backend in ("serial", "fused"):
        for nodes in SORT_NODES:
            label = f"sort {backend} {nodes} nodes"

            def sort_run(backend=backend, nodes=nodes):
                ex = bind.LocalExecutor(nodes, collective_mode="tree",
                                        backend=backend)
                return sort_integers(keys, n_nodes=nodes, executor=ex)

            zero_counts()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            out, stats = sort_run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(isinstance(out, torch.Tensor) and out.device == keys.device
                  and out.dtype == torch.int64,
                  f"{label}: came back as {type(out)} on "
                  f"{getattr(out, 'device', None)}")
            check(torch.equal(out, keys_sorted),
                  f"{label}: differs from torch.sort")
            launched = {k: v for k, v in counts().items() if v}
            check(not launched, f"{label}: launched {launched}")
            print(f"[mapreduce] {label}: 2^{SORT_N.bit_length() - 1} int64 "
                  f"on the card: {wall * 1e3:.3f} ms, shuffle "
                  f"{stats.bytes_transferred} bytes in "
                  f"{stats.message_count} implicit transfers, ops "
                  f"{stats.ops_executed}; equal to torch.sort, on the card")
            del out, stats
            freed(label, base)
            busy = device_profile(torch, label, sort_run, wall, {})
            print(f"[mapreduce] {label}: wall {wall * 1e3:.3f} ms, busy "
                  f"{busy:.1f}%")
    del keys, keys_sorted
    host_keys = np.random.default_rng(SEED).integers(
        0, 2 ** 31 - 1, size=SORT_HOST_N, dtype=np.int64)
    host_sorted = np.sort(host_keys)
    for nodes in SORT_NODES:
        t0 = time.perf_counter()
        out, stats = sort_integers(host_keys, n_nodes=nodes)
        wall = time.perf_counter() - t0
        check(isinstance(out, np.ndarray) and np.array_equal(out, host_sorted),
              f"sort numpy {nodes} nodes: differs from np.sort")
        print(f"[mapreduce] numpy {nodes} nodes: {SORT_HOST_N} int64 on the "
              f"host: {wall * 1e3:.3f} ms, shuffle {stats.bytes_transferred} "
              f"bytes in {stats.message_count} implicit transfers; equal to "
              f"np.sort")
    del host_keys, host_sorted, out, stats
    print(f"[memory] peak allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB")

    lap("[mapreduce]")

    def timed(label, phase, *args):
        t0 = time.perf_counter()
        out = phase(torch, dev, *args)
        print(f"[time] {label}: {time.perf_counter() - t0:.1f} s")
        return out

    # -- 8e. the LM stack: RecurrentGemma-9B served on the card ----------------
    lm = timed("[lm]", lm_phase, gen, card, zero_counts, counts)

    # -- 8f. training: RecurrentGemma-9B's widths, 3 layers, on the card ------
    train = timed("[train]", train_phase, card, zero_counts, counts)

    # -- 8g. the rest of the LM stack: granite-moe-3b-a800m served -------------
    lm_moe = timed("[lm_moe]", lm_moe_phase, gen, card, zero_counts, counts)

    # -- 8h. Moonshot, Seamless, Phi-3-vision, xLSTM at their published widths -
    families = timed("[lm_families]", lm_families_phase, gen, card,
                     zero_counts, counts)

    # -- 8i. training the five, and attention at the shapes they give it ------
    train_fams = timed("[train_families]", train_families_phase, card,
                       zero_counts, counts)
    fam_attn = timed("[attn families]", family_attention_timed, gen, card)

    # -- 8j. training that checkpoints, crashes and resumes ---------------------
    train_ckpt = timed("[train_ckpt]", train_ckpt_phase, card, zero_counts,
                       counts)

    # -- 8k. the LM on rank meshes: explicit DP and expert parallelism -------
    lm_mesh = timed("[lm_mesh]", lm_mesh_phase, card, zero_counts, counts)

    # -- 8l. the dry run on meta ranks, and held to the card ------------------
    dry = timed("[dryrun]", dryrun_phase, card, zero_counts, counts)

    # -- 9. result lines --------------------------------------------------------------
    gemm_source = "src/repro_torch/kernels/gemm/csrc/gemm.cu"
    chain_source = "src/repro_torch/kernels/chain/csrc/chain.cu"
    chain_attn_source = "src/repro_torch/kernels/chain/csrc/chain_attn_tc.cuh"
    gemm_replaces = "src/repro/kernels/gemm/kernel.py:47"
    chain_replaces = "src/repro/core/executable_cache.py:242"
    attn_label = "flash_attention RecurrentGemma-9B float32"
    attn_bf16_label = "flash_attention Qwen3-14B bfloat16"
    attn_f32_label = "flash_attention Qwen3-14B float32"
    scan_label = f"linear_scan RG-LRU {FULL_SCAN} float32"
    rg32 = attn_times[("RecurrentGemma-9B", "float32")]
    gemma32 = train_fams[GEMMA_F32_NAME]
    rows = (
        ("gemm.matmul", gemm_source, gemm_replaces,
         path_counts["listing1"]["gemm.matmul"],
         leaf[("matmul", "float32")]),
        ("gemm.matmul_accumulate", gemm_source, gemm_replaces,
         path_counts["strassen"]["gemm.matmul_accumulate"],
         leaf[("matmul_accumulate", "float32")]),
        ("chain.ewise", chain_source, chain_replaces,
         path_counts["scan chain, x single"]["chain.ewise"],
         chain_times[("ewise", "single")]),
        ("chain.dot", chain_source, chain_replaces,
         path_counts["gemm_tile chain"]["chain.dot"],
         dict(chain_times[("dot", "float32")],
              bfloat16=chain_times[("dot", "bfloat16")],
              float64=chain_times[("dot", "float64")])),
        # on the tensor cores (3xTF32 here; f32_simt's times on the same
        # values inside), bfloat16's numbers and one served level's beside
        # them
        ("chain.attn", chain_attn_source, chain_replaces,
         path_counts["attn_step chain"]["chain.attn"],
         dict(chain_times["attn"],
              bfloat16=dict(chain_times[("attn", "bfloat16")],
                            served_level=chain_times[("attn", "bfloat16",
                                                      "served")]),
              served_level=chain_times[("attn", "float32", "served")])),
        # float16 on the tensor cores (f16_wgmma, gemm_wgmma.cuh's loop
        # instantiated for f16): its launches are Listing 1's in float16
        # on serial, its numbers the 1024^3 leaf's (f16_simt's on the same
        # values beside them)
        ("gemm.matmul.f16",
         "src/repro_torch/kernels/gemm/csrc/gemm_wgmma.cuh", gemm_replaces,
         path_counts["listing1 f16 serial"]["gemm.matmul"],
         dict(leaf[("matmul", "float16->float16")],
              listing1_f16=listing_f16)),
        # the float16 chains on MeshBackend(pallas=True): one launch each
        ("chain.ewise.f16", chain_source, chain_replaces,
         path_counts["scan chain f16, x single"]["chain.ewise"],
         dict(chain_times[("ewise", "single", "float16")],
              x_per_level=chain_times[("ewise", "xs", "float16")])),
        ("chain.dot.f16", chain_source, chain_replaces,
         path_counts["gemm_tile chain f16"]["chain.dot"],
         chain_times[("dot", "float16")]),
        ("chain.attn.f16", chain_attn_source, chain_replaces,
         path_counts["attn_step chain f16"]["chain.attn"],
         dict(chain_times[("attn", "float16")],
              served_level=chain_times[("attn", "float16", "served")])),
        # the CUDA-core loop: its launches in [attn]'s reference cases (d
        # 16 and the views no tensor-core route reads), its numbers at
        # RecurrentGemma-9B's float32 shape on the same values as the
        # 3xTF32 block (q one element in), which took its place there
        ("flash_attention",
         "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/kernel.py:100",
         attn_route_launches["f32_simt"],
         {"max_abs_err": rg32["simt_max_abs_err"], "ms": rg32["simt_ms"],
          "plain_ms": rg32["plain_ms"], "bound_ms": rg32["simt_bound_ms"],
          "bound_by": rg32["bound_by"], "library_ms": rg32["library_ms"]}),
        # the 3xTF32 blocks of d 256: RecurrentGemma-9B's float32 prefill
        # shape, Gemma-7B's training shape beside it
        ("flash_attention.f32_d256",
         "src/repro_torch/kernels/flash_attention/csrc/attn_tf32_wide.cuh",
         "src/repro/kernels/flash_attention/kernel.py:100",
         path_counts[attn_label]["flash_attention"],
         dict(rg32, gemma=attn_times[("Gemma-7B", "float32")])),
        ("flash_attention.bf16",
         "src/repro_torch/kernels/flash_attention/csrc/attn_wgmma.cuh",
         "src/repro/kernels/flash_attention/kernel.py:100",
         path_counts[attn_bf16_label]["flash_attention"],
         attn_times[("Qwen3-14B", "bfloat16")]),
        ("flash_attention.f32",
         "src/repro_torch/kernels/flash_attention/csrc/attn_tf32.cuh",
         "src/repro/kernels/flash_attention/kernel.py:100",
         path_counts[attn_f32_label]["flash_attention"],
         attn_times[("Qwen3-14B", "float32")]),
        # float16 on the tensor cores (f16_wgmma, attn_wgmma.cuh's loop
        # instantiated for f16): no model runs float16, so its launches
        # are those of [attn]'s Qwen3-14B float16 run, its numbers that
        # run's (RecurrentGemma-9B's beside them)
        ("flash_attention.f16",
         "src/repro_torch/kernels/flash_attention/csrc/attn_wgmma.cuh",
         "src/repro/kernels/flash_attention/kernel.py:100",
         path_counts["flash_attention Qwen3-14B float16"]["flash_attention"],
         dict(attn_times[("Qwen3-14B", "float16")],
              rg9b=attn_times[("RecurrentGemma-9B", "float16")])),
        ("linear_scan",
         "src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu",
         "src/repro/kernels/linear_scan/kernel.py:50",
         path_counts[scan_label]["linear_scan"], scan_times["float32"]),
        # no TPU kernel: the reference differentiates its attention oracle
        # (flash_attention/ref.py:7) with XLA's autodiff; the numbers are
        # the [train] phase's, at RecurrentGemma-9B's training shape in bf16
        # on the route the step takes (bf16_wgmma; route_ms has each
        # route's time at both widths)
        ("flash_attention_bwd",
         "src/repro_torch/kernels/flash_attention/csrc/attn_bwd_wgmma.cuh",
         "src/repro/kernels/flash_attention/ref.py:7",
         train["flash_attention_bwd"]["launches"],
         {k: v for k, v in train["flash_attention_bwd"].items()
          if k != "launches"}),
        # the float32 backward on the tensor cores (3xTF32): the launches
        # of one [lm_mesh] FSDP step at h2o-danube-1.8b's 24 layers, the
        # numbers [train]'s at that step's shape
        ("flash_attention_bwd.f32",
         "src/repro_torch/kernels/flash_attention/csrc/attn_bwd_tf32.cuh",
         "src/repro/kernels/flash_attention/ref.py:7",
         lm_mesh["fsdp_full_step"]["flash_attention_bwd"].get(DP_ROUTE, 0),
         {k: v for k, v in train["flash_attention_bwd.f32"].items()
          if k != "route_ms"}),
        # and its blocks of d 256: the launches of [train_families]'
        # Gemma-7B float32 steps, the numbers [train]'s at RecurrentGemma-
        # 9B's training shape (Gemma-7B's beside them)
        ("flash_attention_bwd.f32_d256",
         "src/repro_torch/kernels/flash_attention/csrc/"
         "attn_bwd_tf32_wide.cuh",
         "src/repro/kernels/flash_attention/ref.py:7",
         gemma32["bwd_launches"] * GEMMA_F32_STEPS,
         {k: v for k, v in train["flash_attention_bwd.f32_d256"].items()
          if k != "route_ms"}),
        # the float16 backward on the tensor cores (f16_wgmma): no model
        # runs float16; its launches are [train]'s checked f16 calls at
        # Qwen3-14B's width and RecurrentGemma-9B's training shape, its
        # numbers Qwen3-14B's (RG-9B's beside them)
        ("flash_attention_bwd.f16",
         "src/repro_torch/kernels/flash_attention/csrc/attn_bwd_wgmma.cuh",
         "src/repro/kernels/flash_attention/ref.py:7",
         train["flash_attention_bwd.f16"]["checked_launches"]
         + train["flash_attention_bwd.f16"]["rg9b"]["checked_launches"],
         {k: v for k, v in train["flash_attention_bwd.f16"].items()
          if k not in ("route_ms", "checked_launches")}),
    )
    # the served steps launch the GEMM's accumulate and chain_attn too: one
    # each a step, counted on the launchers in every serving arm
    served = {"gemm.matmul_accumulate": n_kernel_steps,
              "chain.attn": n_kernel_steps}
    kernels = []
    for name, source, replaces, launches, numbers in rows:
        check(launches > 0, f"{name}: never launched on its path")
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches, **numbers))
        if name in served:
            kernels[-1]["serve_launches"] = served[name]
        kernels[-1].update(lm.get(name, {}))
        if name in ("flash_attention", "linear_scan"):
            kernels[-1].update(train[name])
    # the families of the rest of the LM stack: flash_attention's launches
    # and routes a prefill per family, its device time inside the Granite
    # prefill and its times at the families' shapes; the backward's
    # launches a training step per family and its times there
    attn_row = next(k for k in kernels if k["name"] == "flash_attention")
    attn_row["family_launches"] = {
        lm_moe["name"]: {"launches": lm_moe["launches"],
                         "routes": {lm_moe["route"]: lm_moe["launches"]}},
        **{name: {"launches": f["launches"], "routes": f["routes"]}
           for name, f in families.items()}}
    attn_row["granite_ms"] = lm_moe["ms"]
    attn_row["family_shapes"] = {
        name: {k: v for k, v in t.items() if not k.startswith("bwd_")}
        for name, t in fam_attn["bf16"].items()}
    # the float32 training forward at the FSDP step's shape, and its
    # launches on [lm_mesh]'s path (one explicit-DP step, one FSDP step at
    # 24 layers)
    f32_row = next(k for k in kernels if k["name"] == "flash_attention.f32")
    f32_row["family_shapes"] = fam_attn["f32"]
    f32_row["lm_mesh_launches"] = {
        step: lm_mesh[step]["flash_attention"].get(DP_ROUTE, 0)
        for step in ("dp_step", "fsdp_step", "fsdp_full_step")}
    bwd32_row = next(k for k in kernels
                     if k["name"] == "flash_attention_bwd.f32")
    bwd32_row["lm_mesh_launches"] = {
        step: lm_mesh[step]["flash_attention_bwd"].get(DP_ROUTE, 0)
        for step in ("dp_step", "fsdp_step", "fsdp_full_step")}
    bwd32_row["route_ms"] = train["flash_attention_bwd.f32"]["route_ms"]
    # d 256's blocks on the training paths: RecurrentGemma-9B's float32
    # step ([train]) and Gemma-7B's ([train_families]), launches a step
    f256_row = next(k for k in kernels
                    if k["name"] == "flash_attention.f32_d256")
    f256_row["train_launches"] = {
        "RecurrentGemma-9B": train["f32_step_launches"]["flash_attention"],
        "Gemma-7B": gemma32["fwd_launches"]}
    b256_row = next(k for k in kernels
                    if k["name"] == "flash_attention_bwd.f32_d256")
    b256_row["train_launches"] = {
        "RecurrentGemma-9B": train["f32_step_launches"][
            "flash_attention_bwd"],
        "Gemma-7B": gemma32["bwd_launches"]}
    b256_row["route_ms"] = train["flash_attention_bwd.f32_d256"]["route_ms"]
    b256_row["gemma_step"] = {k: gemma32[k] for k in (
        "step_walls_s", "model_tflops", "peak_bytes", "attention_ms",
        "device_ms")}
    # float16: the launches of [attn]'s cases on f16_wgmma, and the
    # families' shapes both ways
    f16_row = next(k for k in kernels if k["name"] == "flash_attention.f16")
    f16_row["attn_launches"] = attn_route_launches["f16_wgmma"]
    f16_row["family_shapes"] = {
        name: {k: v for k, v in t.items() if not k.startswith("bwd_")}
        for name, t in fam_attn["f16"].items()}
    bwd16_row = next(k for k in kernels
                     if k["name"] == "flash_attention_bwd.f16")
    bwd16_row["family_shapes"] = {
        name: {"route": t["bwd_route"], "ms": t["bwd_ms"],
               "plain_ms": t["bwd_plain_ms"], "bound_ms": t["bwd_bound_ms"],
               "library_ms": t["bwd_library_ms"]}
        for name, t in fam_attn["f16"].items()}
    bwd_row = next(k for k in kernels if k["name"] == "flash_attention_bwd")
    bwd_row["family_train_launches"] = {
        name: {"launches": t["bwd_launches"], "routes": t["bwd_routes"]}
        for name, t in train_fams.items()}
    bwd_row["family_shapes"] = {
        name: {"route": t["bwd_route"], "ms": t["bwd_ms"],
               "plain_ms": t["bwd_plain_ms"], "bound_ms": t["bwd_bound_ms"],
               "library_ms": t["bwd_library_ms"],
               **({"simt_ms": t["bwd_simt_ms"]} if "bwd_simt_ms" in t
                  else {})}
        for name, t in fam_attn["bf16"].items()}
    # Listing 1's leaf products inside the procs workers, an iteration's
    # launches summed over the four worker processes
    gemm_row = next(k for k in kernels if k["name"] == "gemm.matmul")
    # matmul's out_dtype at 1024^3: bfloat16 and float16 written as float32
    # beside their own output (no caller on a path passes it, as in the
    # reference)
    gemm_row["out_dtype"] = {pair: leaf[("matmul", pair)] for pair in (
        "bfloat16->float32", "bfloat16->bfloat16", "float16->float32",
        "float16->float16")}
    # on the armed rank mesh: Listing 1's leaves an iteration, one chain
    # launch a chain workflow under pallas="auto"
    for row in kernels:
        if row["name"] in mesh:
            row["mesh_launches"] = mesh[row["name"]]
    gemm_row["mesh"] = mesh["mesh"]
    gemm_row["procs_launches"] = procs["launches"]
    gemm_row["procs_walls_s"] = procs["walls"]
    gemm_row["procs_serial_walls_s"] = procs["serial_walls"]
    gemm_row["faults_recomputed_ops"] = {k: v["recomputed"] if "recomputed"
                                         in v else v
                                         for k, v in faults.items()}
    attn_row["train_ckpt"] = {k: v for k, v in train_ckpt.items()
                              if k != "supervised"}
    # the LM on rank meshes: launches by route of one explicit-DP step (4
    # ranks), one FSDP step at 2 layers and one at full depth (the
    # parameters at rest as shards), one expert-parallel Moonshot prefill
    # and its gradient
    attn_row["lm_mesh"] = {
        "dp_step": lm_mesh["dp_step"]["flash_attention"],
        "fsdp_step": lm_mesh["fsdp_step"]["flash_attention"],
        "fsdp_full_step": lm_mesh["fsdp_full_step"]["flash_attention"],
        "ep_prefill": lm_mesh["ep_prefill"]["flash_attention"],
        "ep_grad": lm_mesh["ep_grad"]["flash_attention"],
        "dp": lm_mesh["dp"], "fsdp": lm_mesh["fsdp"],
        "fsdp_full": lm_mesh["fsdp_full"], "ep": lm_mesh["ep"]}
    # the dry run's card step ([lm_mesh] (d)'s cell): its launches, and the
    # operations the meta trace counted for them
    attn_row["dryrun"] = {"launches": dry["launches"]["flash_attention"],
                          "meta_flops": dry["meta_flops"]["flash_attention"],
                          "cells": dry["cells"]}
    bwd_row["dryrun"] = {
        "launches": dry["launches"]["flash_attention_bwd"],
        "meta_flops": dry["meta_flops"]["flash_attention_bwd"]}
    bwd_row["lm_mesh"] = {
        "dp_step": lm_mesh["dp_step"]["flash_attention_bwd"],
        "fsdp_step": lm_mesh["fsdp_step"]["flash_attention_bwd"],
        "fsdp_full_step": lm_mesh["fsdp_full_step"]["flash_attention_bwd"],
        "ep_grad": lm_mesh["ep_grad"]["flash_attention_bwd"]}
    print(json.dumps({"kernels": kernels}))
    print(f"[time] chip_smoke.py took {time.perf_counter() - T_START:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
