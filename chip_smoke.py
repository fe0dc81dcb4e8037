#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. card and build — prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them, and builds the CUDA kernels from ``src/repro_torch/csrc`` with the
   toolkit's ``nvcc`` (one process per source, all at once);
2. each kernel against its plain PyTorch version, on the card, at the main
   paths' shapes plus ragged sizes, with the tolerance stated beside each
   check; every call must move the kernel's launch counter by one.
   ``fir`` must equal the plain version bit for bit (f32, Q15 int16, int32
   wraparound, int32 taps on an int16 signal, views off 16-byte alignment,
   taps 1 .. 5000), also under every outputs-a-thread count and block
   sizes of 1, 125 and 256 threads (``FirPlan``); ``delineate``'s flags must
   equal the plain version's for f32, int16 and int32, n = 1 .. 33 and
   unaligned views.
   ``stockham_fft`` runs every n from 1 to 8192 (and a row base off 16-byte
   alignment at n = 512), and ``power_spectrum`` must give the bits of
   ``re*re + im*im`` over the card's own ``fft``; ``svm`` must give
   ``svm(0) + b`` bit for bit with the bias as a card tensor, a float and a
   CPU tensor, and runs d = 1024, d = 7 and q that give 4 and 8 queries a
   block (``plan_svm``).  The GeMM's three config tilings must give
   identical bits, int32 included where a tiling splits K across blocks
   (each case logs the split plans, and some must split).  Flash attention
   runs qwen's prefill shape at B = 4 and at the decode engine's B = 1,
   must give a B = 1 call the bits of the same row of a B = 4 call
   (bf16 and f32), and runs a ragged S = T = 300, a suffix with
   ``q_offset``, a non-causal case, Dk = 96 / Dv = 64 in float32 and in
   bfloat16, Dk = Dv = 64 in bfloat16, B = 1, S = T = 4096 in bfloat16,
   moonshot's prefill (B = 1, H = KVH = 16, S = T = 256, D = 128, bf16,
   on ``flash_wgmma_kernel`` with a GQA group of one; a B = 1 call
   bit-equal to row 2 of B = 4), deepseek's MLA prefill (B = 1, H = 128,
   S = T = 256, Dk 192, Dv 128, bf16 on ``flash_wgmma_kernel<192, 128>``
   and f32 on the CUDA-core kernel; a B = 1 call bit-equal to row 2 of
   B = 4 with k built as the MLA block builds it, and no view copied) and
   its training shape (B = 8, H = 128, S = T = 128, bf16 and f32),
   paligemma's prefill (B = 4, H = 8, KVH = 1, S = T = 320, Dk = Dv = 256,
   bf16 and f32, causal and not, bf16 on ``flash_wgmma_kernel<256, 256>``
   and f32 on the CUDA-core kernel; a B = 1 call bit-equal to row 2 of
   B = 4 in both dtypes) and its training shape (B = 8, S = T = 384),
   hubert's heads (H = 16, D = 80, non-causal, f32 and bf16, bf16 on
   ``flash_wgmma_kernel<80, 80>``; and causal at a ragged S = T = 77), a ragged
   Dk = Dv = 256 at 77 rows, rows that see no key (``q_offset = -16``; at
   D = 128 and at Dk = Dv = 256, bf16 and f32), and a bfloat16 view that no
   TMA tensor map describes (rows D + 1 elements apart), which the wrapper
   must copy once (``CONTIGUOUS_COPIES``).  ``rwkv6_scan`` runs bf16 and
   f32 inputs with ``state0`` absent, zero and random at T = 1, 256 and 300
   and D = 64 and 32 (the engine's B = 1, T = 256 prefill among them),
   must give a B = 1 call the bits of the same row of a B = 4 call (T =
   256 and 1, output and state), and decays drawn near 1 and near 0 (w = exp(-exp(x)),
   x over [-6, 3]) at the prefill shape and at T = 300, D = 32;
   ``decode_attention`` must give a B = 1 call the bits of the same row of
   a B = 4 call (output and partial triple, bf16 and f32, T = 512, 4096 and
   32768), and runs qwen's decode shape in bf16, a
   ragged MHA T = 300 in f32, an MQA group at Dk = Dv = 256, T = 32768,
   T = 1 and an MQA group of 16 at T = 1000, each with ``partial=True`` over
   the whole cache (the combine pass's unnormalized output where the split
   plan cuts T) and over 4 T-shards combined against the full result; the
   plans must include a single split, several, and a T that is no multiple
   of ``keys_per_split``, and each case's plan is logged;
   ``mamba_scan`` jamba's width (Dm = 16384, N = 16) at the engine's
   prefill (B = 1, T = 256), B = 4, T = 256 and B = 1, T = 4096 with the
   dtypes the jamba block passes under bf16,
   a ragged T = 100, ``state0``, N = 32, bf16 rows of Dm = 300 and 301
   (no 16-byte copy describes them: the kernel's element-wise path, x and
   delta both bf16 at 301) and decays from 0 to 0.99999 over T = 512; each
   case logs its lane count (``plan_mamba``) and copy path, and every lane
   count and both paths must run; a B = 1 call must give the bits of the
   same row of a B = 6 call (x bf16 and f32);
   ``flash_attention_bwd`` (the training path's gradient) through the
   differentiable wrapper (q, k, v requiring grad, ``out.backward``)
   against autograd of the plain version on the same values in f32, in
   bf16 and f32: stablelm-1.6b's training shape (B = 8, 32 heads of 64,
   S = T = 128, causal), qwen's GQA (16 over 2 heads of 128, S = T = 256),
   the example model's (12 over 4 of 64), hubert's (16 of 80, S = T = 256
   and its training shape B = 8, S = T = 128, non-causal), ragged S = 77
   and 100 at D = 32, 80 and 96, and deepseek's
   MLA (Dk 192, Dv 128) at its training shape (B = 8, 128 heads, S = T =
   128), phase 9's prefill (B = 1, S = T = 256) and a ragged S = 77, and
   paligemma's heads (8 over one kv head of 256) at its training shape (B
   = 8, S = T = 384), its prefill (B = 4, S = T = 320) and a ragged S =
   77; the forward's output bit-equal with and without the log-sum-exp it
   keeps for the backward, two calls bit-equal and a B = 1 call bit-equal
   to row 2 of B = 4 or 8 (stablelm's, qwen's, deepseek's, paligemma's
   and hubert's training shapes), and (Dk, Dv) = (256, 128) refused with a
   ``ValueError`` (no fallback); bf16 at D 32, 64, 80, 96, 128 and 256 and
   at (192, 128) runs the tensor-core kernels, f32 the CUDA-core ones;
   ``decode_attention`` with each row's ``lengths``, as the model's decode
   step calls it, against the masked plain version: lengths 1, mid, T and
   33 at qwen's step, a ragged T = 300, paligemma's D = 256 and T = 32768
   (splits wholly past a row's length), bf16 and f32, out in the cache
   dtype and f32; every row alone bit-equal to the batched row, and keys
   past a row's length never read;
   ``norm`` in every form the models run (RMS, LayerNorm, rwkv's groups of
   64, the audio frontend's LayerNorm with a bias), bf16 and f32, at
   d = 2048, 2560, 4096, 8192, 512, 1536 and 1280: a row alone bit-equal to
   row 2 of a (4, 64, d) batch; deepseek's latent slice (kv_a[..., :512] of
   576) read in place, one launch a call and a profiled call running the
   norm kernel and no copy; and the autograd backward against the plain
   version's;
   ``rwkv6_scan_bwd`` and ``mamba_scan_bwd`` (the training path's scan
   gradients) against autograd of their plain versions on the same values
   in f32, bf16 and f32: rwkv6-3b's training shape (B = 8, H = 40, T =
   128, D = 64), a ragged T = 77, D = 32, T = 1, and T = 256 (whose chunk
   states go to a scratch buffer), w drawn log-uniform in [0.05, 1), and
   the model's transposed (B, H, T, D) views read in place (the backward's
   two kernels and no copy in a profiled call, the gradients in the views'
   layout); jamba's (B = 8, T = 128, Dm = 16384, N = 16), ragged Dm =
   300 and 301 (delta bf16 too), N = 32, 8, 4 and 2, T = 300 (whose
   chunk states go to a scratch buffer), and b and c on bases off 16 bytes
   (element loads, bit-equal to aligned b and c); f32 gradients within 1e-5
   of their largest magnitude, bf16 ones within one bf16 ulp more; every
   call bit-equal to a second one; ``rwkv6_scan_bwd`` against the float64
   sequential gradient with w drawn down to 1e-12 (and 5 % of it 0), within
   1e-4 of each gradient's largest magnitude (the plain chunked version's
   dw is no yardstick there, and is logged beside); through autograd
   (``rwkv6_scan``, ``selective_scan`` with inputs requiring grad) one
   forward and one backward launch, the gradients bit-equal to the
   backward's own, and a ``state0`` refused; the modes the sharded paths
   give two kernels (``cp_and_t_split``): the context-parallel shard
   (``flash_attention`` at a ``q_offset``) at paligemma's heads, S_local = 512 of T =
   8192 at ``q_offset`` 0, 512 x 7 and 512 x 15, bf16 and f32, forward and
   backward kernels against the plain version at that offset; the T-split
   decode step (``decode_max``, ``decode_partial``, ``combine_shards``) at
   qwen's step cut into 4 T-blocks, one holding no key, against the
   unsplit ``lengths`` call and the plain two-pass version; then their
   device times beside bounds (the shard's backward also beside SDPA's
   backward with the shard's mask);
   2b. the four TinyBio kernels with a leading batch axis, for B = 1, 2,
   4, 8: ``fir`` (f32 and Q15 int16), ``delineate`` (with extrema at every
   row's edges), ``power_spectrum`` on (B, 128, 512) and ``svm`` on
   (B, 128, 36) (the bias a card tensor and a float) must give each row
   the bits of its single call, ``fir`` and ``delineate`` the plain
   version's bits on the whole batch, the ``torch.func.vmap`` of each
   wrapper the batched call's bits, and a ``torch.profiler`` trace one
   device kernel per batched call;
3. kernel timings at the main paths' shapes: device time per call from
   CUDA events around replays of a CUDA graph of many warm calls, for the
   kernel, its plain version and, where one PyTorch call computes the same
   function, that call (``library_ms``); the eager cost per call, host
   dispatch included, is logged beside them.  ``bound_ms`` is the least time
   the card could take, from the bytes and operations of this run's inputs.
   ``power_spectrum`` is timed beside ``fft``, against the parent's four
   launches (``fft``, then ``re*re + im*im``), and an empty kernel
   (``csrc/launch_floor.cu``) gives the card's launch floor; a
   ``torch.profiler`` trace must show one device kernel per call of
   ``svm_decision``, ``power_spectrum``, ``fir`` and ``delineate``.  The
   plan ``fir`` took is logged, and the bound of its bits (an FMUL and an FADD per tap and output, no fused
   multiply-add) beside the FMA bound, with Q15 int16 timed at the same
   shape.  Each batched TinyBio call at B = 4 is timed beside four single
   calls and the launch floor.
   The GeMM is also timed at 2048³, where launch latency no longer hides
   the kernel's own rate; flash attention at qwen's prefill shape and at
   B = 1, S = T = 4096, at deepseek's MLA prefill (Dk 192, Dv 128), at
   paligemma's (B = 4, H = 8, KVH = 1, S = T = 320, D = 256) and at
   stablelm's, deepseek's and paligemma's training shapes (keeping the
   log-sum-exp), against ``F.scaled_dot_product_attention``; the backward
   at deepseek's and paligemma's training and prefill shapes against
   SDPA's backward, with the kernels each dtype's route ran;
   ``rwkv6_scan`` at rwkv6-3b's prefill (B = 4, T = 256) and decode-step
   (T = 1) shapes, with B = 1, T = 4096 beside them; ``decode_attention``
   at qwen's decode shape and at T = 32768, against SDPA with one query,
   with its split plan, and at T = 32768 also with the plan sized for one
   sequence alone (the rule the batch-free plan did not take); each
   attention row logs its share of the bound;
   ``mamba_scan``'s kernel at jamba's width at the engine's prefill,
   B = 1, T = 256, with B = 4, T = 256, B = 2, T = 128 (phase 4c's shape)
   and B = 1, T = 4096 beside it, each
   with its byte bound and the special-function unit's floor (one
   exponential per step, channel and state); ``flash_attention_bwd`` at
   stablelm's training shape in bf16, beside its bound (the five products
   a backward needs), the plain version (autograd through the plain
   forward) and ``scaled_dot_product_attention``'s backward (its forward
   and backward less its forward), its device time by kernel, and qwen's
   GQA shape (B = 4, 16 over 2 heads of 128,
   S = T = 256), and deepseek's MLA at its training and prefill shapes
   (beside SDPA's forward and its forward + backward, by kernel; a
   profiler trace of a forward and a backward at (192, 128) must name
   ``flash_wgmma_kernel<192, 128>`` and ``flash_{dq,dkdv}_wgmma_kernel<192,
   128>`` in bf16, ``flash_kernel<float, 128>`` and
   ``flash_{dq,dkdv}_kernel<192, 128>`` in f32, once each), paligemma's
   likewise, and hubert's heads (16 of 80, non-causal) at its training
   shape (B = 8, S = T = 128: the forward keeping the log-sum-exp and the
   backward, on ``flash_wgmma_kernel<80, 80>`` and
   ``flash_{dq,dkdv}_wgmma_kernel<80, 80>``) and its encode shape (B = 4,
   S = T = 256: the forward), each beside SDPA's forward and backward;
   ``decode_attention`` with lengths at qwen's step (the row
   the kernels line reports) against SDPA with a mask; ``norm`` at qwen's
   step and prefill, stablelm's training forward, rwkv's group norm and
   deepseek's latent norm, against ``F.rms_norm``, ``F.layer_norm`` and
   ``F.group_norm`` (and deepseek's latent slice read in place);
   ``rwkv6_scan_bwd`` (also on the model's transposed views) and
   ``mamba_scan_bwd`` at the training shapes beside their bounds and plain
   versions (autograd through the plain forward; no library call computes
   either); the registers and spills of the kernels of ``norm.cu``,
   ``rwkv6_scan_bwd.cu`` and ``mamba_scan_bwd.cu``
   (``benchmarks_torch/ptxas_report.py``, compiled beside phase 2);
4. the two main paths, each with the launch counters reset just before and
   read just after:

   * TinyBio — ``run_tinybio`` on the card for the 4T, 8T and 16T configs,
     in graph and eager mode, at the paper's full workload: each of its
     kernels must have launched once per graph offload and twice per eager
     one.  The decisions of graph and eager must agree bitwise, every
     report must equal the CPU run's field for field, and every stage's
     output must match the CPU run's within the stated tolerances;
   * GeMM (paper Fig 3) — the quickstart's 256³ int32 ``APU.offload`` for
     the 4T, 8T and 16T configs, graph and eager: ``gemm`` must have
     launched once per graph offload and twice per eager one, the outputs
     must be exact and every report equal to the CPU run's; then the
     ports of the Fig-3, transfer and multi-queue benches on the card,
     their modeled rows equal to the CPU run's;
   * 4c. the registry's ``decode_attention`` and ``mamba_scan`` families
     (the port reached these two kernels only through the registry until
     phase 10 served jamba):
     ``Program.build(cfg).create_kernel(...)`` for 4T, 8T and 16T, through a
     ``CommandQueue`` and ``APU.offload`` (graph and eager): each result
     equal to the op's, each report equal to the CPU run's, and each kernel
     launched once per enqueue and graph offload and twice per eager one;
   * 4d. the queue options with the registry's ``gemm`` (256³ int32) and
     TinyBio families at the paper's size (65,536 samples, 128 taps, FFT
     128 × 512, SVM 128 queries × 256 × 36), on 16T: the default queue, an
     unprofiled blocking one (``profile=False, blocking=True``) and a
     windowed one (``max_events=2``), the latter two with blocking
     transfers.  Outputs bit-equal to the default queue's, blocking events
     ``done`` on return, the unprofiled ``finish()`` releasing every event,
     the windowed totals ``==`` the full-history queue's, one launch an
     enqueue, ``dispatch_s > 0`` on every kernel event (also once released),
     ``flush()`` returning; ``create_buffer`` aliasing a card tensor
     (``copy=False``, ``use_host_ptr=True``), copying on ``copy=True`` and
     refusing a CPU tensor.  Then ``bench_dispatch``'s eager-sync, async
     and graph microseconds a kernel on the card, and ``bench_static``'s
     rows;

5. the LM serving path (qwen2.5-3b at full width and depth, bf16, random
   weights from ``init_params(seed=0)`` on the card): ``greedy_generate``
   answers 4 requests of 256-token prompts with 16 new tokens each, with
   the launch counters reset just before and read just after:
   ``flash_attention`` must launch once per layer per prefill and never in
   a decode step, ``decode_attention`` once per layer per decode step,
   ``norm`` at every norm of each prefill and step (exact counts), the
   tokens must repeat on a second run, and a ``torch.profiler`` trace of
   one prefill must show the hand-written kernel and no library attention
   kernel, one of a decode step the norm and decode kernels and no PyTorch
   norm reduction (a mean or ``torch.var``).  Prefill and per-step decode
   walls, tokens/s, the device's busy and idle share of one prefill and one
   decode step, and peak device memory are printed;
   5b. the card against the CPU: a 2-layer cut of qwen2.5-3b at full width
   in float32, the same parameters on both, prefill of 2 × 64 tokens and
   4 decode steps teacher-forced from the CPU's tokens: logits within the
   stated tolerances, greedy tokens equal;

6. the rwkv serving path (rwkv6-3b at full width and depth: 32 layers,
   d_model 2560, 40 heads of 64, bf16, random weights from seed 0 on the
   card): ``greedy_generate`` answers 4 requests of 256-token prompts with
   16 new tokens each; ``rwkv6_scan`` must launch once per layer in the
   prefill and in every decode step, ``norm`` at every norm (three a
   layer, with the per-head group norm), and no other kernel of ours; the
   tokens must repeat on a second run.  Walls, tokens/s, the device's idle
   share of one prefill and one decode step, ``rwkv6_kernel``'s device time
   in the prefill (``rwkv6_step_kernel`` in a decode step), and peak memory
   are printed;
   6b. the card against the CPU: a 2-layer cut of rwkv6-3b at full width in
   float32, as in 5b;

7. TinyBio served on the card at full size: ``Server`` over a 16T and an
   8T ``QueueWorker``, ``bucket_sizes=(65536,)``, ``max_batch=4``, warmed
   up, then 16 requests (``synth_signal``, seeds 0..15) with the launch
   counters reset just before and read just after (one launch a stage a
   micro-batch).  Every request's decisions must equal ``APU.offload`` of
   it alone on the card bit for bit; the cache must miss exactly once per
   lane, at warmup; on a virtual clock every modeled ``ServeReport`` field
   must equal the CPU port's run (``==``); a traced twin must give complete
   request trees, a valid Chrome trace and the same bits and report; a
   ``FaultPlan`` run (a lane blacked out, seeded failures) must retry and
   give the same bits.  The serving wall, requests/s, the device's idle
   share of one warm micro-batch and a warm ``APU.offload`` graph wall are
   printed side by side;

   7b. ``bench_overload`` and ``bench_power`` on the card: every modeled row
   ``==`` the same bench's CPU run, their gates and bit-identity checks
   holding on the card; each bench's wall on the card and on the CPU;

8. the continuous-batching decode engine at full width and depth, for
   qwen2.5-3b and rwkv6-3b (bf16, random weights from seed 0, the f32
   tree ``init_params`` makes): ``DecodeEngine(num_slots=4,
   max_len=512)`` behind an engine-only ``Server``; after one short
   request captures both graphs, six 256-token requests of 16 new tokens
   arrive staggered, with the launch counters reset just before and read
   just after (qwen: ``flash_attention`` once per layer per prefill, none
   in a step, ``decode_attention`` once per layer per step; rwkv:
   ``rwkv6_scan`` once per layer per prefill and per step; both: ``norm``
   at every norm; no other kernel of ours).  Two requests must take freed
   slots while others still decode; every request's tokens must equal the
   card's ``greedy_generate`` of the six prompts as one batch, bit for
   bit, and so must each prompt's ``greedy_generate`` alone (B = 1:
   ``benchmarks_torch/batch_bits.py`` names any op whose bits depend on the
   batch); a profiled warm step runs the norm kernel and no PyTorch norm
   reduction; the cache
   must have missed twice; every modeled ``stats()`` field must equal the
   CPU's over a 2-layer f32 cut at full width.  The served wall, tokens/s
   of wall, a warm prefill's and a warm step's wall, one warm step's
   device busy time and idle share (``torch.profiler``) and peak memory
   are printed;

9. the MoE and MLA blocks through the decode engine (the models of
   phases 5-8 freed first): moonshot-v1-16b-a3b at full width and depth
   (48 layers, 64 experts of 1408, top-6, 56.1 GB) and deepseek-v2-236b at
   full width cut to 4 layers (its dense first layer, then three MLA + MoE
   layers of 160 experts, top-6, with two shared experts; 26.6 GB), each
   a bf16 tree drawn from seed 0 on the card (``DecodeEngine`` counts the
   modeled bytes of that bf16 tree).  Each is served as in phase 8 (one
   short request to capture, six staggered 256-token requests of 16 new
   tokens, two taking freed slots): ``flash_attention`` once per layer per
   prefill and never in a step, ``decode_attention`` once per layer per
   step (moonshot; deepseek's MLA keeps its absorbed products, one row at
   a time), ``norm`` at every norm (MLA's latent norms included), no other
   kernel of ours, no view copied for a tensor map, tokens equal to the
   card's ``greedy_generate`` of the six prompts as one batch and of each
   alone, 2 cache misses; a ``torch.profiler`` trace of
   one warm prefill names the flash kernel that ran, and only it
   (moonshot's D = 128 and deepseek's Dk 192 / Dv 128 on
   ``flash_wgmma_kernel``), and no library attention kernel.  Walls, tokens/s,
   a warm step's busy time and idle share, and the peak memory after each
   model are printed.  Then an f32 cut of each at full width (moonshot:
   one layer, its layers being all alike; deepseek: its dense first layer
   and one MoE layer, so the shared experts and the dense layer run on the
   card only there), the same
   parameters on the card and the CPU: prefill of 2 × 64 tokens and 4
   decode steps teacher-forced from the CPU's tokens within 5b's
   tolerances, greedy tokens equal, and every modeled ``stats()`` field of
   the staggered engine run ``==`` the CPU's;

10. the Mamba block and the vision frontend (phase 9's models freed
   first).  10a: jamba-1.5-large-398b at full width (d_model 8192, 64
   heads over 8 of 128, Mamba d_inner 16384, d_state 16, dt_rank 512, 16
   experts of 24576, top-2, vocab 65536) cut to its first four layers
   (mamba + dense, mamba + MoE, mamba + dense, attention + MoE; a period
   of eight is 88 GB in bf16), a bf16 tree of 23.0 G parameters drawn on
   the card, served as in phase 9: ``mamba_scan`` three times a prefill
   (once a mamba layer) and never in a step, ``flash_attention`` once a
   prefill on ``flash_wgmma_kernel<128, 128>``, ``decode_attention`` once
   a step, ``norm`` at every norm, tokens equal to ``greedy_generate`` of
   the six prompts as one batch and of each alone, 2 cache misses;
   then its first layer alone (mamba + dense MLP) in f32 against the CPU,
   as phase 9's cuts (tokens, logits, every ``stats()`` field).  10b:
   paligemma-3b at full width and depth (18 layers, 8 heads over one kv
   head of 256, GeGLU 16384, vocab 257216 tied; 2.51 G parameters in
   bf16): four requests of 256 patch rows of 1152 features (numpy) and 64
   tokens as one batch through ``make_prefill_step``, 16 greedy tokens
   through ``make_decode_step(return_logits=False)``: ``flash_attention``
   18 times a prefill on ``flash_wgmma_kernel<256, 256>`` and never in
   a step, ``decode_attention`` 18 times a step (D 256), ``norm`` at every
   norm, no library attention kernel, the tokens repeating on a second
   run; then a 2-layer f32 cut with 256 patch rows against the CPU.
   Walls, tokens/s, idle shares and peak memory are printed;

11. the training path (phase 10's models freed first), each run with the
   launch counters reset just before and read just after.  11a:
   stablelm-1.6b at full width and depth (24 layers, d_model 2048, 32
   heads of 64, d_ff 5632, vocab 100352; 1.64 G f32 parameters) through
   ``launch.train.train_loop`` with the launcher's defaults (batch 8, seq
   128, f32 masters, bf16 compute, bf16 moments, remat "none") for 5
   steps: ``flash_attention`` and ``flash_attention_bwd`` once a layer a
   step, ``norm`` once a norm of each forward (its backward is PyTorch ops
   on the kernel's statistics), no other kernel of ours, every loss
   finite and the first within
   0.5 of ln V + 1/2; a trainer from ``build_host_trainer`` then gives the
   warm step wall, tokens/s, peak memory and a profiled step (busy time,
   idle share, the hand-written forward and backward kernels (the
   backward's on the tensor cores, ``flash_{dq,dkdv}_wgmma_kernel``), the norm kernel
   and no library attention kernel: neither SDPA's forward nor its backward,
   flash, memory-efficient or cuDNN).  Then a 2-layer f32 cut at full
   width, card against CPU: loss, every leaf's gradient, parameters and
   moments after 2 steps within the stated tolerances, and ``remat="dots"``
   and ``"full"`` bit-equal to ``remat="none"`` on the card.  11b: the ~86M model of
   ``examples/train_lm_torch.py``, 150 steps: the loss falls by 0.5 or
   more; a checkpoint restart (24 steps, killed after 16, resumed) gives
   the uninterrupted run's losses bit for bit.  11c: hubert-xlarge's
   encode at full width and depth (48 layers, bf16) on 4 x 256 frames:
   ``flash_attention`` once a layer on ``flash_wgmma_kernel<80, 80>``,
   bit-equal on a second call; a 2-layer f32 cut against the CPU.  11d-11f
   (``TRAIN_FAMILIES``): moonshot-v1-16b-a3b at full width cut to 4 layers
   (2.95 G parameters; its 48 are ~337 GB of training state),
   deepseek-v2-236b cut to its dense MLA first layer (1.39 G; one MoE
   layer more would not fit beside it) and hubert-xlarge at full width and
   depth, each as 11a (5 steps through ``train_loop`` with the launch
   counters read; then a trainer's first and warm step walls, tokens/s,
   peak memory and a profiled step, in which each flash kernel of the
   arch's route must run once a layer: deepseek's bf16 forward on
   ``flash_wgmma_kernel<192, 128>`` and its backward on
   ``flash_{dq,dkdv}_wgmma_kernel<192, 128>``, hubert's on
   ``flash_wgmma_kernel<80, 80>`` and ``flash_{dq,dkdv}_wgmma_kernel<80,
   80>``); the first loss within 0.5 of ln V + 1/2 plus the MoE layers'
   aux at a uniform routing; then an f32 cut (moonshot 2 layers, deepseek
   its first layer, hubert 2 layers) on the card against the CPU: every
   MoE routing slot equal first, then the loss, ``load_balance`` and
   ``router_z`` within 1e-5 relative, every gradient within 1e-4 of its
   max |g|, remat bit-equal.  11g: paligemma-3b at full width and depth
   (18 layers, 2.51 G f32 parameters), each batch 8 x 128 tokens behind
   256 patch rows (S = T = 384 in attention), run as 11d-11f: its bf16
   attention on ``flash_wgmma_kernel<256, 256>`` and
   ``flash_{dq,dkdv}_wgmma_kernel<256, 256>`` once a layer, then a
   2-layer f32 cut against the CPU.  11h-11i (``SCAN_FAMILIES``): rwkv6-3b
   at full width and depth (32 layers, 3.07 G f32 parameters) and jamba's
   first layer at full width (mamba + dense MLP, 2.10 G), run as 11a: the
   scan's forward and backward kernels (``rwkv6_kernel`` and
   ``rwkv6_bwd_kernel``, ``mamba_kernel`` and ``mamba_bwd_kernel``) once a
   layer a step, counted and in the profiled step, and no plain scan
   called on the card (``plain_scan_guard``); the profiled step's kernels
   of the scan's backward are logged with their launches and device ms
   and their share of the busy time; then a 1-layer f32 cut of
   each against the CPU (rwkv's with two train steps on 2 x 128 tokens,
   as 11a; jamba's on 1 x 128, the CPU's own time being most of it);

12. the distribution layer.  12a: TinyBio at full size (65,536 samples,
   a 128-tap FIR, 128 windows of 512, an SVM of 256 x 36) served as 16
   requests through ``Server`` with ``EGPU_16T`` on three sharded lanes
   (``SHARDED_LANES``): a ``ShardedWorker`` over the card at one mesh
   position, at two positions (``data=2``, the one H100 at both; each
   micro-batch of 4 splits into two launches, one a position, each on its
   position's own stream) and the ``max_batch=3`` fallback (3 rows do not
   split over 2, so one replicated launch); the counters reset just before
   each lane's run and read just after, then around single micro-batches:
   each TinyBio kernel launched once a micro-batch a shard, nothing else;
   a profiled run of the same requests gives the idle share (its trace
   must hold no more of those kernels than ran; one that lost some in
   every window is logged, its idle share not read).  Every output bit-equal to a plain
   ``QueueWorker`` lane on the card; on a virtual clock every modeled
   ``ServeReport`` field (shards, mesh axes and utilization among them)
   and the cache stats equal the same lane's CPU run.  The wall per
   request and the idle share are printed.  12b: the collective layer on
   NCCL in a world of one rank (``launch.mesh.make_host_mesh()``):
   ``compressed_psum`` of stablelm-1.6b's embedding gradient (100352 x
   2048 f32, 822 MB), its mean and new error equal to the CPU codec's bits
   and its gathered payload int8 (the collective wrapped and its dtype
   read); the ~86M example model's tree distributed under
   ``TRAIN_FSDP_RULES``, gathered, saved and restored with
   ``restore_sharded`` onto the mesh, every leaf's bits kept; the group
   destroyed at the end of the phase.  12c: the models under the sharding
   rules on ``make_host_mesh()`` (NCCL, world 1), every tensor a DTensor
   and every kernel reached through ``distributed.sharding.on_blocks``:
   one stablelm-1.6b step (phase 11a's model whole, batch 8 x 128) under
   ``TRAIN_FSDP_RULES`` from the seed's state, bit-equal in loss, every
   parameter and both moments to the unsharded step from a copy of that
   state (the counters reset just before the sharded step and read just
   after: flash_attention and flash_attention_bwd once a layer, norm at
   every norm); then qwen2.5-3b at full depth in bf16 under
   ``SERVE_RULES``: phase 5's prefill and 15 decode steps, the counters
   read as phase 5's, the prefill's and every step's logits and the greedy
   tokens bit-equal to phase 5's; both walls beside the unsharded ones;

13. one ``{"kernels": [...]}`` line for all thirteen kernels (launches: phase
   4's main paths, plus phase 4d's, phase 7's and phase 12's for the GeMM
   and TinyBio kernels, phases 8's, 9's, 10's, 11's and 12c's for
   ``flash_attention``, 11's and 12c's for ``flash_attention_bwd``, 8's and 11h's for ``rwkv6_scan``, 10's
   and 11i's for ``mamba_scan``, 11h's and 11i's for ``rwkv6_scan_bwd``
   and ``mamba_scan_bwd``, phases 5's, 8's, 9's, 10's and 12c's for
   ``decode_attention`` (after 4c's registry launches) and phases 5, 6,
   8-11 and 12c for ``norm``),
   then, last, ``{"ok": true, "device": {...}}``.  Each phase logs its
   wall time.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The card's published peaks (H100 SXM data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# INT32 multiply-adds per clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0), times the SMs
# and the card's max SM clock from nvidia-smi give the int32 peak.
INT32_MAC_PER_CLK_PER_SM = 64
# FP32 adds or multiplies per clock per SM, from the same table.
FP32_LANES_PER_CLK_PER_SM = 128
# Exponentials (MUFU.EX2) per clock per SM, from the same table.
SFU_PER_CLK_PER_SM = 16

TINYBIO_KERNELS = {
    "fir": ("src/repro_torch/csrc/fir.cu", "src/repro/kernels/fir/fir.py:27"),
    "delineate": ("src/repro_torch/csrc/delineate.cu",
                  "src/repro/kernels/delineate/delineate.py:22"),
    "stockham_fft": ("src/repro_torch/csrc/stockham_fft.cu",
                     "src/repro/kernels/stockham_fft/stockham_fft.py:29"),
    "svm": ("src/repro_torch/csrc/svm.cu", "src/repro/kernels/svm/svm.py:22"),
}
GEMM_KERNELS = {
    "gemm": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm/gemm.py:27"),
}
LM_KERNELS = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:29"),
}
# the gradient of the same TPU kernel, which the JAX package leaves to
# jax.grad of its XLA path
TRAIN_KERNELS = {
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention/flash_attention.py:29"),
}
REGISTRY_KERNELS = {
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/decode_attention.py:29"),
    "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan/mamba_scan.py:26"),
}
RWKV_KERNELS = {
    "rwkv6_scan": ("src/repro_torch/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:34"),
}
# the models' norms, which the JAX package leaves to XLA: the kernel
# replaces no TPU kernel, and names the XLA norm it computes
NORM_KERNELS = {
    "norm": ("src/repro_torch/csrc/norm.cu",
             "none: src/repro/models/layers.py:37 (apply_norm, left to XLA)"),
}
# the two scans' gradients, which the JAX package leaves to jax.grad of its
# XLA paths: the kernels replace no TPU kernel, and name that path
SCAN_BWD_KERNELS = {
    "rwkv6_scan_bwd": ("src/repro_torch/csrc/rwkv6_scan_bwd.cu",
                       "none: src/repro/kernels/rwkv6_scan/ops.py:22 "
                       "(jax.grad of the XLA path, _chunk_body)"),
    "mamba_scan_bwd": ("src/repro_torch/csrc/mamba_scan_bwd.cu",
                       "none: src/repro/kernels/mamba_scan/ops.py:33 "
                       "(jax.grad of the XLA path, _chunked_assoc)"),
}
KERNELS = {**TINYBIO_KERNELS, **GEMM_KERNELS, **LM_KERNELS, **TRAIN_KERNELS,
           **REGISTRY_KERNELS, **RWKV_KERNELS, **NORM_KERNELS,
           **SCAN_BWD_KERNELS}
# the LM path's geometry (qwen2.5-3b) and its serving run
LM_ARCH = "qwen2.5-3b"
LM_BATCH, LM_PROMPT, LM_NEW, LM_MAX_LEN = 4, 256, 16, 512
# the rwkv serving path (rwkv6-3b) and its run; jamba gives mamba_scan
# its width (d_inner, d_state)
RWKV_ARCH = "rwkv6-3b"
RWKV_BATCH, RWKV_PROMPT, RWKV_NEW, RWKV_MAX_LEN = 4, 256, 16, 512
# the decode engine's serving run (phase 8), for both models
ENGINE_SLOTS, ENGINE_REQUESTS, ENGINE_PROMPT, ENGINE_NEW, ENGINE_MAX_LEN = (
    4, 6, 256, 16, 512)
# the MoE and MLA families (phase 9): (arch, layers served on the card,
# layers of the f32 cut held against the CPU); deepseek-v2-236b's 60 layers
# (471 GB in bf16) fit no card, and its cut needs the dense first layer and
# one MoE layer; moonshot's layers are all alike, so one does
MOE_ARCHS = (("moonshot-v1-16b-a3b", 48, 1), ("deepseek-v2-236b", 4, 2))
MAMBA_ARCH = "jamba-1.5-large-398b"
# phase 10a: jamba's first four layers (mamba/dense, mamba/moe, mamba/dense,
# attn/moe) at full width; one period of 8 (88 GB in bf16) fits no card
MAMBA_LAYERS = 4
# phase 10b: paligemma-3b at full width and depth, 4 requests of 256 patch
# rows of 1152 features and 64 text tokens, 16 greedy tokens each
PALI_ARCH = "paligemma-3b"
PALI_BATCH, PALI_TEXT, PALI_NEW, PALI_MAX_LEN = 4, 64, 16, 512
# phase 11: the training path.  11a: the launcher's default arch and
# defaults (python -m repro_torch.launch.train: batch 8, seq 128, f32
# masters, bf16 compute, remat "none"), at full width and depth; 11b: the
# ~86M model of examples/train_lm_torch.py; 11c: hubert's encode
TRAIN_ARCH = "stablelm-1.6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 5
EXAMPLE_STEPS, EXAMPLE_BATCH, EXAMPLE_SEQ = 150, 4, 64
ENCODE_ARCH = "hubert-xlarge"
ENCODE_BATCH, ENCODE_FRAMES = 4, 256
# 11d-11g: (phase, arch, layers trained at full width (None: all), layers
# of the f32 cut held against the CPU).  moonshot's 48 layers are ~28 G
# parameters, ~337 GB of training state at 12 bytes each (f32 master and
# gradient, bf16 moments): four layers are 2.95 G, ~35 GB.  deepseek's
# dense MLA first layer alone is 1.39 G (~17 GB); one MoE layer of 162
# experts more would be 5.36 G (~64 GB, and ~15 GB of bf16 expert casts
# and their gradients): its MoE training is held on the CPU, moonshot's
# carries routed experts at full width here.  hubert trains whole (0.95 G),
# and so does paligemma (2.51 G, ~30 GB of state), its 8 x 128 tokens
# behind 256 patch rows.
TRAIN_FAMILIES = (("11d", "moonshot-v1-16b-a3b", 4, 2),
                  ("11e", "deepseek-v2-236b", 1, 1),
                  ("11f", "hubert-xlarge", None, 2),
                  ("11g", "paligemma-3b", None, 2))
# 11h-11i: the recurrent families, (phase, arch, layers trained at full
# width (None: all; jamba's first layers, jamba_cut), layers of the f32 cut,
# whether the cut also takes two train steps, the cut's batch of 128-token
# rows: the cut's time is mostly the CPU's).  rwkv6-3b whole (32 layers,
# 3.07 G parameters, ~34.3 GiB of training state); jamba's first layer,
# mamba + dense MLP (2.10 G, ~23.4 GiB): its second, mamba + MoE, is 10.1 G
# more (~113 GiB) and fits no card, so jamba's MoE after a mamba block
# trains on the CPU only (tests/test_torch_train_jamba.py), as deepseek's
# MoE does.  rwkv's cut is one layer: at two, a relative change of 1e-7 in
# the parameters moves the CPU's own gradients by 1.5e-4 of a leaf's
# largest magnitude (one layer: 9.4e-6; benchmarks_torch/grad_conditioning.py),
# so no two f32 summation orders need meet the rule of 1e-4 there.
SCAN_FAMILIES = (("11h", "rwkv6-3b", None, 1, True, 2),
                 ("11i", "jamba-1.5-large-398b", 1, 1, False, 1))
#: (forward, backward) device kernels of each recurrent block's scan
SCAN_KERNEL_NAMES = {"rwkv": ("rwkv6_kernel<", "rwkv6_bwd_kernel<"),
                     "mamba": ("mamba_kernel<", "mamba_bwd_kernel<")}
# every device kernel of a scan's backward call (the partials' sums too)
SCAN_BWD_KERNEL_NAMES = {"rwkv": ("rwkv6_bwd_kernel<", "rwkv6_du_sum_kernel"),
                         "mamba": ("mamba_bwd_kernel<", "mamba_bwd_sum_kernel")}
# the hand-written flash-attention kernels (csrc/flash_attention.cu), and
# names of library attention kernels the LM path must not run
FLASH_KERNEL_NAMES = ("flash_kernel<", "flash_wgmma_kernel<")
# the backward's kernels: its dQ kernels, then its dK/dV kernels, each on
# the tensor cores (bf16 at BWD_MMA_PAIRS) and on the CUDA cores
FLASH_BWD_DQ_NAMES = ("flash_dq_wgmma_kernel<", "flash_dq_kernel<")
FLASH_BWD_DKDV_NAMES = ("flash_dkdv_wgmma_kernel<", "flash_dkdv_kernel<")
FLASH_BWD_KERNEL_NAMES = FLASH_BWD_DQ_NAMES + FLASH_BWD_DKDV_NAMES
# the norm kernel, and PyTorch's reductions a norm in plain ops runs (its
# means and torch.var), which no decode step may run
NORM_KERNEL_NAMES = ("norm_kernel<",)
# the sources whose kernels' registers and spills phase 3 logs
PTXAS_SOURCES = ("norm.cu", "rwkv6_scan_bwd.cu", "mamba_scan_bwd.cu")
NORM_REDUCTIONS = ("MeanOps", "WelfordOps")
LIBRARY_ATTENTION = ("fmha", "sdpa", "cudnn", "attention", "pytorch_flash",
                     "flash_fwd", "flash_bwd")


class SmokeFailure(RuntimeError):
    pass


def attn_dims(cfg):
    """(Dk, Dv) of ``cfg``'s attention: an MLA block's nope + rope against
    v_head_dim, else the head dim twice."""
    if cfg.attn_kind == "mla":
        return cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    return cfg.head_dim, cfg.head_dim


def engine_flash_dims(cfg):
    """The decode engine's prefill of one ENGINE_PROMPT-token prompt as it
    reaches flash_attention for ``cfg``: ((B, H, KVH, S, T, Dk, Dv),
    scale).  An MLA block attends each head to its own keys (KVH = H) at
    Dk = nope + rope against Dv, scaled by Dk ** -0.5 (None: the kernel's
    default, Dk ** -0.5 too)."""
    dk, dv = attn_dims(cfg)
    if cfg.attn_kind == "mla":
        return ((1, cfg.n_heads, cfg.n_heads, ENGINE_PROMPT, ENGINE_PROMPT,
                 dk, dv), dk ** -0.5)
    return ((1, cfg.n_heads, cfg.n_kv_heads, ENGINE_PROMPT, ENGINE_PROMPT,
             dk, dv), None)


def layer_kinds(cfg) -> list:
    """The block kind of each layer of ``cfg``: the scanned layers, then a
    dense first layer's."""
    from repro_torch.models.transformer import _layer_kinds, n_scanned
    kinds = [_layer_kinds(cfg, layer)[0] for layer in range(n_scanned(cfg))]
    if cfg.first_layer_dense:
        kinds.append(cfg.block_pattern[0])
    return kinds


def norms_per_pass(cfg) -> int:
    """Norm kernel launches of one prefill, one decode step or one forward
    of ``cfg``: two a layer (norm1, norm2), one more a layer for rwkv's
    per-head group norm and two more for MLA's latent norms, the final
    norm, and the audio frontend's LayerNorm."""
    per = {"attn": 2, "mamba": 2, "rwkv": 3, "mla": 4}
    return (1 + sum(per[k] for k in layer_kinds(cfg))
            + int(cfg.frontend == "audio"))


def train_launches(cfg, steps: int) -> dict:
    """Kernel launches of ``steps`` train steps of ``cfg`` (remat "none":
    no forward runs again): the flash forward and backward once an
    attention or MLA layer a step, the scan's forward and backward once an
    rwkv or mamba layer a step, ``norm`` once a norm of each forward (its
    backward is PyTorch ops on the kernel's statistics)."""
    kinds = layer_kinds(cfg)
    attn = kinds.count("attn") + kinds.count("mla")
    want = {"flash_attention": attn, "flash_attention_bwd": attn,
            "rwkv6_scan": kinds.count("rwkv"),
            "rwkv6_scan_bwd": kinds.count("rwkv"),
            "mamba_scan": kinds.count("mamba"),
            "mamba_scan_bwd": kinds.count("mamba"),
            "norm": norms_per_pass(cfg)}
    return {k: v * steps for k, v in want.items() if v}


def attn_layers(cfg) -> int:
    """Layers of ``cfg`` whose decode step attends through
    ``decode_attention`` (the ``attn`` blocks; MLA keeps its products)."""
    return layer_kinds(cfg).count("attn")


def model_launches(cfg, prefills: int, steps: int, **others) -> dict:
    """The launches of ``prefills`` prefills (or forwards) and ``steps``
    decode steps of ``cfg`` by kernel: ``norm`` at every norm,
    ``decode_attention`` once an attention layer a step, and ``others``
    as given."""
    return dict(others, norm=norms_per_pass(cfg) * (prefills + steps),
                decode_attention=attn_layers(cfg) * steps)


def check_step_kernels(per_kernel, what, cfg):
    """A profiled decode step ran the norm kernel and, where ``cfg`` has
    attention layers, ``decode_split_kernel``; and no PyTorch reduction
    of a norm (a mean or torch.var)."""
    names = list(per_kernel)
    check(any(n in k for k in names for n in NORM_KERNEL_NAMES),
          f"{what}: the profiled step ran no norm kernel")
    if attn_layers(cfg):
        check(any("decode_split_kernel<" in k for k in names),
              f"{what}: the profiled step ran no decode_split_kernel")
    reductions = [k[:90] for k in names if any(r in k for r in NORM_REDUCTIONS)]
    check(not reductions, f"{what}: the profiled step ran PyTorch's norm "
          f"reductions: {reductions}")


#: the phase a run is in and when it began (host clock), for phase_done
_PHASE = {"name": None, "t0": 0.0}


def phase_done(next_name=None) -> None:
    """Log the wall time of the phase that ends here, and start timing
    ``next_name``."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        log(f"phase {_PHASE['name']}: {now - _PHASE['t0']:.1f} s of wall")
    _PHASE.update(name=next_name, t0=now)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float, ops_per_s: float = PEAK_FP32_FLOPS):
    """(least ms, what bounds it) for moving ``nbytes`` and doing ``flops``
    operations at ``ops_per_s``."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def fir_bits_bound(n: int, taps: int, sms: int, max_sm_mhz: float) -> float:
    """Least ms of an FIR whose bits forbid the fused multiply-add: an FMUL
    and an FADD per tap and output at 128 FP32 lanes a clock per SM (the
    Q15 path's one IMAD at 64 a clock takes the same time)."""
    return 2.0 * n * taps / (FP32_LANES_PER_CLK_PER_SM * sms * max_sm_mhz * 1e6) * 1e3


def nvidia_smi(query: str) -> str:
    smi = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


#: the device kernels of ``torch.cuda._sleep`` and of the port's empty
#: kernel (``csrc/launch_floor.cu``), launched first in every profiled
#: window and left out of what the window reports: a trace on the card can
#: miss the first kernel of a session, and the first one a session launches
#: through the port's library (which links its own copy of the CUDA
#: runtime): a profiled call of one ``fir`` launch came back with no
#: kernel, and forward-then-backward windows without their forward, while
#: a PyTorch kernel alone opened the window
MARKER_KERNELS = ("spin_kernel", "launch_floor_kernel")
#: forward-then-backward calls in a window that names a flash route
ROUTE_CALLS = 3


def profiler_marker(torch) -> None:
    from repro_torch.kernels import common
    torch.cuda._sleep(1000)
    launch_floor(common)(1, 32)
    torch.cuda.synchronize()


def traced(torch, body):
    """``body()`` under ``torch.profiler`` between marker kernels, in one
    window: -> (the profile, body's result).  A trace's last device event
    is lost on the card machines (a window came back with its leading
    marker and without the one kernel ``body`` ran; with one trailing
    marker, that marker was lost in most windows of a full run), so two
    markers follow ``body`` to take the loss.  A trace that kept neither of
    them may have lost a kernel of ``body``: it fails the run, and is never
    read (no window of a full run with two trailing markers has lost
    both)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import common
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiler_marker(torch)
        out = body()
        for _ in range(2):
            launch_floor(common)(1, 32)
        torch.cuda.synchronize()
    floors = sum(ev.device_type == DeviceType.CUDA
                 and "launch_floor_kernel" in ev.name for ev in prof.events())
    check(floors >= 2, f"a profiler window's trace lost {3 - floors} of its 3 "
          f"marker kernels (both trailing ones): the window is not read")
    return prof, out


def device_profile(torch, fn, counts=None):
    """Run ``fn`` once under ``torch.profiler``: (host wall s, device busy
    s, device microseconds by kernel name).  Only device-side events
    (kernels and copies) count — a CPU op's row would count its kernels'
    time a second time — and busy time is the union of their intervals.
    A ``counts`` dict receives the number of device events by name."""
    from torch.autograd import DeviceType

    def body():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prof, wall_s = traced(torch, body)
    per_kernel = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or any(m in ev.name
                                                      for m in MARKER_KERNELS):
            continue
        t0_us, t1_us = ev.time_range.start, ev.time_range.end
        spans.append((t0_us, t1_us))
        per_kernel[ev.name] = per_kernel.get(ev.name, 0.0) + (t1_us - t0_us)
        if counts is not None:
            counts[ev.name] = counts.get(ev.name, 0) + 1
    busy_us, reach = 0.0, -math.inf
    for t0_us, t1_us in sorted(spans):
        busy_us += max(0.0, t1_us - max(t0_us, reach))
        reach = max(reach, t1_us)
    return wall_s, busy_us * 1e-6, per_kernel


def profile_ours(torch, fn, names, want: int, what: str, tries: int = 3):
    """:func:`device_profile` of ``fn`` with the device events counted by
    name, taken again (at most ``tries`` windows in all) while the trace
    holds fewer than ``want`` events whose names contain one of ``names``:
    on some machines a window's trace drops a kernel of ours that ran (a
    forward-then-backward window came back without its forward, in bf16
    and in f32), so a short trace is logged and taken again, never read.
    -> (host wall s, device busy s, us by kernel, events by kernel)."""
    for _ in range(tries):
        counts = {}
        wall_s, busy_s, per_kernel = device_profile(torch, fn, counts)
        got = sum(c for k, c in counts.items() if any(n in k for n in names))
        if got >= want:
            break
        log(f"{what}: the trace holds {got} of the {want} device kernels of "
            f"ours the window ran; taking it again")
    return wall_s, busy_s, per_kernel, counts


def kernel_name(name: str) -> str:
    """A device kernel's function name, without its namespace, template
    arguments and parameters."""
    head = name.split("(")[0] if not name.startswith("void (") else name[5:]
    head = head.replace("(anonymous namespace)::", "").split("<")[0]
    return head.split()[-1] if head.split() else name[:40]


def profile_line(what: str, wall_s: float, busy_s: float, per_kernel) -> str:
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    idle = "not measured" if busy_s == 0 else f"{1 - busy_s / wall_s:.4f}"
    return (f"{what}: wall {wall_s * 1e3:.3f} ms, device busy "
            f"{busy_s * 1e3:.4f} ms, idle share {idle}; device us by kernel: "
            + "; ".join(f"{k[:60]} {v:.1f}" for k, v in top))


def device_kernels(torch, fn, calls: int):
    """Names of the device kernels that ``calls`` calls of ``fn`` ran, from
    a ``torch.profiler`` trace (copies and memsets included)."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    prof, _ = traced(torch, body)
    return [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA
            and not any(m in ev.name for m in MARKER_KERNELS)]


def launch_floor(common):
    """``floor(blocks, threads)`` launches ``csrc/launch_floor.cu``'s empty
    kernel on the current stream (no counter: no path of the port runs
    it)."""
    import ctypes
    import torch
    fn = common.kernel_library().repro_launch_floor
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def floor(blocks: int, threads: int) -> None:
        dev = torch.cuda.current_device()
        err = fn(blocks, threads, dev, torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"the empty kernel failed to launch: CUDA error {err}")
    return floor


def call_ms(torch, fn, iters: int, warmup: int = 10) -> float:
    """Mean milliseconds per eager call over ``iters`` back-to-back calls,
    host dispatch included (CUDA events around the loop)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, per_graph: int, replays: int = 20) -> float:
    """Mean device milliseconds per call: ``per_graph`` calls captured into
    one CUDA graph, replayed ``replays`` times between CUDA events, so the
    host's dispatch cost drops out and only the launches' device time (and
    the small gaps between graph nodes) remains."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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
    return start.elapsed_time(end) / (per_graph * replays)


def staggered(srv, prompts, max_new, pull):
    """Serve six prompts staggered through an engine-only ``Server`` (two,
    two more after ``pull`` tokens of the first, two more after ``pull``
    more, which wait for freed slots); -> (rids, whether those two took
    freed slots while others still decoded)."""
    rids = [srv.submit_decode(prompts[i], max_new=max_new) for i in (0, 1)]
    first = srv.stream(rids[0])
    for _ in range(pull):
        next(first)
    rids += [srv.submit_decode(prompts[i], max_new=max_new) for i in (2, 3)]
    for _ in range(pull):
        next(first)
    rids += [srv.submit_decode(prompts[i], max_new=max_new) for i in (4, 5)]
    for _ in first:
        pass
    reused = set(rids[2:]) <= set(srv._eng_active)
    srv.flush()
    return rids, reused


def cut_stats(torch, np, cut, tree, device):
    """stats() of the staggered engine run (4 slots, six 64-token prompts
    from numpy seed 3, 16 new tokens each, max_len 128) of the model
    ``cut`` with the parameter tree ``tree`` (moved to ``device``)."""
    from repro_torch.models.params import map_tree
    from repro_torch.serve import DecodeEngine, Server
    eng = DecodeEngine(cut, map_tree(lambda t: t.to(device), tree),
                       num_slots=ENGINE_SLOTS, max_len=128,
                       cache_dtype=torch.bfloat16, device=device)
    srv = Server((), workers=(), engine=eng)
    prompts = np.random.default_rng(3).integers(
        0, cut.vocab, (ENGINE_REQUESTS, 64)).astype(np.int32)
    _, reused = staggered(srv, prompts, ENGINE_NEW, 5)
    check(reused, f"{cut.name}: the cut's staggered run reused no slot mid-run")
    return eng.stats()


def stats_match_cpu(torch, np, dev, cut, tree, what):
    """Every modeled stats() field of :func:`cut_stats` on the card ``==``
    the CPU's, over the same tree."""
    card_stats = cut_stats(torch, np, cut, tree, dev)
    cpu_stats = cut_stats(torch, np, cut, tree, "cpu")
    for key in cpu_stats:
        check(card_stats[key] == cpu_stats[key],
              f"{what} {cut.n_layers}-layer cut: stats()[{key!r}] "
              f"{card_stats[key]} on "
              f"the card, {cpu_stats[key]} on the CPU")


def cut_run(torch, model, device, prompt, feed=None, patches=None):
    """Prefill ``prompt`` after ``patches`` where given (max_len 128 more
    than the patch rows) and 4 decode steps; each step is fed ``feed[i]``
    or, with no feed, this run's own greedy token.  -> (logits, tokens) on
    the CPU."""
    from repro_torch.models.transformer import decode_step, prefill
    inputs = {"tokens": prompt.to(device)}
    n_patches = 0
    if patches is not None:
        inputs["patches"] = patches.to(device)
        n_patches = patches.shape[1]
    lg, c = prefill(model, inputs, 128 + n_patches)
    out_logits, out_tokens = [lg.cpu()], [torch.argmax(lg, -1).cpu()]
    s = prompt.shape[1] + n_patches
    for i in range(4):
        tok_in = out_tokens[-1] if feed is None else feed[i]
        lg, c = decode_step(model, c, tok_in.to(device), s + i)
        out_logits.append(lg.cpu())
        out_tokens.append(torch.argmax(lg, -1).cpu())
    return out_logits, out_tokens


def card_against_cpu(torch, np, dev, cut, what, kernel="flash_attention",
                     per_step=0, patches=0):
    """A cut at full width in f32 (phases 5b, 6b, 9 and 10), the same
    parameters on the card and the CPU (drawn on the CPU, seed 0): prefill
    of 2 x 64 tokens (numpy seed 1), after ``patches`` rows of vision
    features each where asked, and 4 decode steps teacher-forced from the
    CPU's tokens.  The card's f32 matmuls (TF32 off) and kernels sum in
    another order than the CPU's matmuls and plain versions: prefill logits
    within 1e-4 of max |logit|; decode within 1e-2, since a key that
    differs in its last bits can round to the neighbouring bf16 value in
    the cache (the CPU tests hold the port to the JAX package with the same
    tolerances); greedy tokens equal; ``kernel`` launched once per layer of
    the card's prefill and ``per_step`` times a layer per step.  -> (the
    relative logits errors, the CPU tree)."""
    from repro_torch.models.frontends import feature_dim
    from repro_torch.kernels import common
    from repro_torch.models.params import init_params, map_tree
    from repro_torch.models.transformer import Transformer, model_spec
    tree = init_params(model_spec(cut), 0, device="cpu")
    on_cpu = Transformer(cut, tree)
    on_card = Transformer(cut, map_tree(lambda t: t.to(dev), tree))
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cut.vocab, (2, 64)))
    feats = (torch.from_numpy(rng.standard_normal(
        (2, patches, feature_dim(cut))).astype(np.float32))
        if patches else None)
    cpu_logits, cpu_tokens = cut_run(torch, on_cpu, "cpu", prompt,
                                     patches=feats)
    before = common.LAUNCHES[kernel]
    card_logits, card_tokens = cut_run(torch, on_card, dev, prompt,
                                       feed=cpu_tokens, patches=feats)
    check(common.LAUNCHES[kernel] - before == cut.n_layers * (1 + 4 * per_step),
          f"{what}: the card run did not launch {kernel} once per layer of "
          f"its prefill and {per_step} times a layer per step")
    errs = []
    for i, (g, w) in enumerate(zip(card_logits, cpu_logits)):
        rtol = 1e-4 if i == 0 else 1e-2
        scale = float(w[:, :cut.vocab].abs().max())
        e = float((g[:, :cut.vocab].double()
                   - w[:, :cut.vocab].double()).abs().max())
        errs.append(e / scale)
        check(e <= rtol * scale, f"{what}: card vs CPU logits, step {i}: "
              f"error {e} against max |logit| {scale}")
    check(all(torch.equal(g, w) for g, w in zip(card_tokens, cpu_tokens)),
          f"{what}: card and CPU greedy tokens differ")
    del on_card
    torch.cuda.empty_cache()
    return errs, tree


def serve_engine(torch, np, dev, cfg, ours, tree_dtype=None):
    """The decode engine's serving run of ``cfg`` (phases 8, 9 and 10a): weights
    from seed 0 drawn on the card (``tree_dtype``: f32 by default, as
    ``init_params`` makes them), ``DecodeEngine(num_slots=4, max_len=512,
    bf16 cache)`` behind an engine-only ``Server``; one short request
    captures both graphs, then six 256-token requests of 16 new tokens
    arrive staggered (two, two after 5 tokens, two after 5 more, which
    wait for freed slots), with the launch counters reset just before and
    read just after: each kernel of ``ours`` ({name: (launches a prefill,
    launches a step)}) launches that often (``norm`` at every norm and
    ``decode_attention`` once an attention layer a step, unless ``ours``
    says otherwise), no other kernel of ours, and no view is copied for a
    tensor map.  Each request's tokens must equal the card's
    ``greedy_generate`` of the six prompts as one batch, bit for bit, and
    so must each prompt's ``greedy_generate`` alone (B = 1): every op of
    the path gives a row the bits it has alone
    (``benchmarks_torch/batch_bits.py`` names any op that does not).  The
    cache must miss twice.  A ``torch.profiler`` trace of a warm prefill
    names the flash kernel that ran (``flash_wgmma_kernel`` at the head
    dims of ``MMA_HEAD_DIMS``) and no library attention kernel; one of a
    warm step the norm and decode kernels and no PyTorch norm reduction.
    -> its numbers."""
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import flash_attention as fa_module
    from repro_torch.models.params import init_params, leaves_with_path
    from repro_torch.models.transformer import model_spec
    from repro_torch.serve import DecodeEngine, Server
    from repro_torch.train.serve import greedy_generate
    arch = cfg.name
    npp = norms_per_pass(cfg)
    ours = dict({"norm": (npp, npp), "decode_attention": (0, attn_layers(cfg))},
                **ours)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = init_params(model_spec(cfg), 0, dtype=tree_dtype or torch.float32,
                       device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in leaves_with_path(tree))
    eng = DecodeEngine(cfg, tree, num_slots=ENGINE_SLOTS,
                       max_len=ENGINE_MAX_LEN, cache_dtype=torch.bfloat16)
    srv = Server((), workers=(), engine=eng)
    check(srv.device.type == "cuda" and eng.worker.device.type == "cuda",
          f"{arch}: the engine does not run on the card")
    model_gib = torch.cuda.memory_allocated() / 2 ** 30
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab, (ENGINE_REQUESTS, ENGINE_PROMPT)).astype(np.int32)
    t0 = time.perf_counter()
    warm = srv.submit_decode(prompts[0], max_new=2)
    srv.flush()
    srv.result(warm)
    torch.cuda.synchronize()
    capture_wall = time.perf_counter() - t0
    steps0, prefills0 = eng.n_steps, eng.n_prefills
    copies = fa_module.CONTIGUOUS_COPIES
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    rids, reused = staggered(srv, prompts, ENGINE_NEW, 5)
    torch.cuda.synchronize()
    served_wall = time.perf_counter() - t0
    moved = dict(common.LAUNCHES)
    n_steps = eng.n_steps - steps0
    n_prefills = eng.n_prefills - prefills0
    check(n_prefills == ENGINE_REQUESTS, f"{arch}: {n_prefills} prefills")
    for name in KERNELS:
        per_prefill, per_step = ours.get(name, (0, 0))
        want = per_prefill * n_prefills + per_step * n_steps
        check(moved[name] == want,
              f"{arch} engine path launched {name} {moved[name]} times, "
              f"expected {want} ({n_prefills} prefills, {n_steps} steps)")
    check(fa_module.CONTIGUOUS_COPIES == copies,
          f"{arch}: the served path copied a view for a tensor map")
    check(reused, f"{arch}: no slot was released and reused mid-run")
    check(eng.cache.misses == 2, f"{arch}: engine cache {eng.cache.stats()}")
    got = np.stack([srv.result(r)[0] for r in rids])
    check(got.shape == (ENGINE_REQUESTS, ENGINE_NEW)
          and bool(((got >= 0) & (got < cfg.vocab)).all()),
          f"{arch}: served tokens are not (6, 16) ids below the vocabulary")
    ref = greedy_generate(eng.model, prompts, ENGINE_NEW,
                          ENGINE_MAX_LEN).cpu().numpy()
    check(np.array_equal(got, ref),
          f"{arch}: engine tokens differ from greedy_generate of the six "
          f"prompts as one batch: first differing token per request "
          f"{[int(np.argmax(g != r)) if (g != r).any() else -1 for g, r in zip(got, ref)]}")
    alone = np.concatenate([greedy_generate(
        eng.model, prompts[i:i + 1], ENGINE_NEW, ENGINE_MAX_LEN).cpu().numpy()
        for i in range(ENGINE_REQUESTS)])
    check(np.array_equal(alone, ref),
          f"{arch}: a prompt decoded alone (B = 1) parts from the batch of "
          f"six: first differing token per request "
          f"{[int(np.argmax(a != r)) if (a != r).any() else -1 for a, r in zip(alone, ref)]}")
    # walls: warm prefills of one 256-token prompt, warm steps over four
    # occupied slots (each step ends in its tokens' read-back)
    state = eng.init_state()
    for i in range(ENGINE_SLOTS):
        state = eng.insert(eng.prefill(None, prompts[i]), state, i)
    torch.cuda.synchronize()
    pre = []
    for i in range(3):
        t0 = time.perf_counter()
        eng.prefill(None, prompts[4 + i % 2])
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t0)
    steps = []
    for _ in range(5):
        t0 = time.perf_counter()
        state, _ = eng.generate(None, state)
        steps.append(time.perf_counter() - t0)
    step_profile = device_profile(torch, lambda: eng.generate(None, state))
    check_step_kernels(step_profile[2], f"{arch} engine step", cfg)
    p_wall, p_busy, p_kernels = device_profile(
        torch, lambda: eng.prefill(None, prompts[5]))
    library = [k for k in p_kernels
               if any(t in k.lower() for t in LIBRARY_ATTENTION)]
    check(not library, f"{arch}: the prefill ran library attention kernels: "
          f"{library}")
    flash = sorted(k for k in p_kernels
                   if any(n in k for n in FLASH_KERNEL_NAMES))
    dims = attn_dims(cfg)
    if "flash_attention" in ours:
        tensor_cores = dims in fa_module.MMA_HEAD_DIMS
        want = FLASH_KERNEL_NAMES[tensor_cores]
        check(bool(flash) and all(want in k for k in flash),
              f"{arch}: (Dk, Dv) = {dims} ran {flash}, expected only the "
              f"{'tensor-core' if tensor_cores else 'CUDA-core'} {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = {"dims": dims, "n_params": n_params, "init_s": init_s,
           "model_gib": model_gib, "launches": moved, "n_steps": n_steps,
           "capture_wall": capture_wall, "served_wall": served_wall,
           "tokens_per_s": ENGINE_REQUESTS * ENGINE_NEW / served_wall,
           "prefill_ms": sorted(pre)[1] * 1e3,
           "step_ms": sorted(steps)[2] * 1e3, "profile": step_profile,
           "prefill_profile": (p_wall, p_busy, p_kernels), "flash": flash,
           "peak_gib": peak, "stats": eng.stats(), "first": got[0].tolist()}
    del eng, srv, tree, state
    torch.cuda.empty_cache()
    return out


def jamba_cut(cfg, n_layers: int, dtype=None):
    """jamba's first ``n_layers`` layers (its block and mlp patterns cut to
    their first entries), at full width."""
    return dataclasses.replace(
        cfg, n_layers=n_layers, block_pattern=cfg.block_pattern[:n_layers],
        mlp_pattern=cfg.mlp_pattern[:n_layers], dtype=dtype or cfg.dtype)


def serve_mamba(torch, np, dev, base, card):
    """Phase 10a: jamba at full width, its first :data:`MAMBA_LAYERS`
    layers on a bf16 tree drawn on the card, through the decode engine as
    phase 9 serves (:func:`serve_engine`): ``mamba_scan`` once per mamba
    layer per prefill and never in a step (a step runs the plain one-step
    recurrence, as the JAX decode does), ``flash_attention`` once per
    attention layer per prefill on ``flash_wgmma_kernel<128, 128>``; then
    its first layer alone (mamba / dense) in f32, the card against the CPU.
    -> the launches of the served run."""
    from repro_torch.models.params import leaves_with_path
    cfg = jamba_cut(base, MAMBA_LAYERS)
    n_mamba = cfg.block_pattern.count("mamba")
    n_attn = cfg.block_pattern.count("attn")
    e = serve_engine(torch, np, dev, cfg,
                     {"mamba_scan": (n_mamba, 0),
                      "flash_attention": (n_attn, 0)},
                     tree_dtype=torch.bfloat16)
    scans = sorted(k for k in e["prefill_profile"][2] if "mamba_kernel" in k)
    check(bool(scans), f"{base.name}: the profiled prefill ran no "
          f"mamba_kernel: {sorted(e['prefill_profile'][2])[:12]}")
    log(f"phase 10a: {base.name}: {cfg.n_layers} layers at full width "
        f"({'/'.join(f'{b}+{m}' for b, m in zip(cfg.block_pattern, cfg.mlp_pattern))}; "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} "
        f"of {cfg.head_dim}, Mamba d_inner {cfg.mamba_d_inner}, d_state "
        f"{cfg.mamba_d_state}, dt_rank {cfg.mamba_dt_rank}, {cfg.n_experts} "
        f"experts of {cfg.d_ff_expert} top-{cfg.top_k}, vocab {cfg.vocab}), "
        f"{e['n_params']} parameters drawn in bf16 on the card in "
        f"{e['init_s']:.3f} s ({e['model_gib']:.3f} GiB allocated with the "
        f"engine); DecodeEngine({ENGINE_SLOTS} slots, max_len "
        f"{ENGINE_MAX_LEN}): {ENGINE_REQUESTS} staggered requests of "
        f"{ENGINE_PROMPT} tokens, {ENGINE_NEW} new each, in {e['n_steps']} "
        f"steps; tokens == greedy_generate of the six prompts as one batch "
        f"and of each alone; "
        f"2 cache misses (capture run {e['capture_wall']:.3f} s); launches "
        f"{e['launches']}; the prefill ran {e['flash']} and {scans}; first "
        f"request's tokens {e['first']}")
    log(f"phase 10a: {base.name} on {card}: served wall "
        f"{e['served_wall']:.3f} s, {e['tokens_per_s']:.1f} tokens/s of "
        f"wall; warm prefill (B = 1, {ENGINE_PROMPT} tokens) wall "
        f"{e['prefill_ms']:.3f} ms (median of 3); warm step ({ENGINE_SLOTS} "
        f"slots, tokens read back) wall {e['step_ms']:.3f} ms (median of "
        f"5); peak device memory {e['peak_gib']:.3f} GiB")
    log(f"phase 10a: {base.name}: " + profile_line("one warm engine step",
                                                   *e["profile"]))
    log(f"phase 10a: {base.name}: " + profile_line(
        "one warm engine prefill", *e["prefill_profile"]))
    log(f"phase 10a: {base.name}: stats " + json.dumps(e["stats"]))
    cut = jamba_cut(base, 1, "float32")
    t0 = time.perf_counter()
    cut_errs, cut_tree = card_against_cpu(torch, np, dev, cut, base.name,
                                          kernel="mamba_scan")
    stats_match_cpu(torch, np, dev, cut, cut_tree, base.name)
    n_cut = sum(t.numel() for _, t in leaves_with_path(cut_tree))
    log(f"phase 10a: {base.name}: its first layer alone (mamba + dense MLP) "
        f"at full width in f32, {n_cut} parameters ({n_cut * 4 / 1e9:.1f} "
        f"GB), card vs CPU: greedy tokens equal over prefill + 4 decode "
        f"steps; logits error / max |logit| "
        + ", ".join(f"{x_:.3g}" for x_ in cut_errs)
        + f"; every stats() field of the staggered engine run == the CPU's; "
        f"{time.perf_counter() - t0:.1f} s")
    del cut_tree
    torch.cuda.empty_cache()
    return e["launches"]


def serve_vision(torch, np, dev, cfg, card):
    """Phase 10b: paligemma at full width and depth on a bf16 tree drawn on
    the card (seed 0): :data:`PALI_BATCH` requests as one batch, each
    256 patch rows of 1152 features (numpy seed 2) before
    :data:`PALI_TEXT` text tokens, prefilled through ``make_prefill_step``
    and :data:`PALI_NEW` greedy tokens through ``make_decode_step(
    return_logits=False)`` from position 256 + 64, as the JAX package's
    ``tests/test_arch_smoke.py`` drives it (the engine, like the JAX one,
    takes token prompts only).  The launch counters are reset before a
    second run and read after it: ``flash_attention`` once per layer per
    prefill on ``flash_wgmma_kernel<256, 256>`` (bf16 at (256, 256) runs
    the tensor cores) and never in a step,
    ``decode_attention`` once a layer a step (D 256), ``norm`` at every
    norm; no other kernel of ours and no library attention kernel; the
    second run's tokens equal the first's; a profiled step runs no PyTorch
    norm reduction.  Then a 2-layer f32 cut, the card against the CPU, with 256
    patch rows before each prompt.  -> the launches of the counted run."""
    from repro_torch.kernels import common
    from repro_torch.models.frontends import feature_dim
    from repro_torch.models.params import init_params, leaves_with_path
    from repro_torch.models.transformer import Transformer, model_spec
    from repro_torch.train.serve import make_decode_step, make_prefill_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = init_params(model_spec(cfg), 0, dtype=torch.bfloat16, device=dev)
    model = Transformer(cfg, tree)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in leaves_with_path(tree))
    rng = np.random.default_rng(2)
    n_patch = cfg.n_prefix_embed
    inputs = {
        "tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (PALI_BATCH, PALI_TEXT))).to(dev),
        "patches": torch.from_numpy(rng.standard_normal(
            (PALI_BATCH, n_patch, feature_dim(cfg))).astype(np.float32)).to(dev)}
    prefill_step = make_prefill_step(cfg, PALI_MAX_LEN)
    step = make_decode_step(cfg, return_logits=False)
    pos0 = n_patch + PALI_TEXT

    def generate():
        logits, cache = prefill_step(model, inputs)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out = [tok]
        for i in range(PALI_NEW - 1):
            tok, cache = step(model, cache, tok, pos0 + i)
            out.append(tok)
        return torch.stack(out, 1).cpu().numpy()

    t0 = time.perf_counter()
    first = generate()
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    common.reset_launches()
    t0 = time.perf_counter()
    got = generate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moved = dict(common.LAUNCHES)
    want = model_launches(cfg, 1, PALI_NEW - 1, flash_attention=cfg.n_layers)
    for name in KERNELS:
        check(moved[name] == want.get(name, 0), f"{cfg.name}: the served run "
              f"launched {name} {moved[name]} times, expected "
              f"{want.get(name, 0)}")
    check(got.shape == (PALI_BATCH, PALI_NEW)
          and bool(((got >= 0) & (got < cfg.vocab)).all()),
          f"{cfg.name}: tokens are not ({PALI_BATCH}, {PALI_NEW}) ids below "
          f"the vocabulary")
    check(np.array_equal(first, got),
          f"{cfg.name}: a second run gave other tokens")
    pre = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, cache = prefill_step(model, inputs)
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t0)
    tok = torch.from_numpy(got[:, 0]).to(dev)
    steps = []
    for i in range(5):
        t0 = time.perf_counter()
        tok, cache = step(model, cache, tok, pos0 + i)
        tok.cpu()
        steps.append(time.perf_counter() - t0)
    step_profile = device_profile(
        torch, lambda: step(model, cache, tok, pos0 + 5)[0].cpu())
    check_step_kernels(step_profile[2], f"{cfg.name} decode step", cfg)
    p_wall, p_busy, p_kernels = device_profile(
        torch, lambda: prefill_step(model, inputs))
    library = [k for k in p_kernels
               if any(t in k.lower() for t in LIBRARY_ATTENTION)]
    check(not library, f"{cfg.name}: the prefill ran library attention "
          f"kernels: {library}")
    flash = sorted(k for k in p_kernels
                   if any(n in k for n in FLASH_KERNEL_NAMES))
    check(bool(flash) and all("flash_wgmma_kernel<256, 256>" in k
                              for k in flash),
          f"{cfg.name}: the prefill ran {flash}, expected "
          f"flash_wgmma_kernel<256, 256>")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"phase 10b: {cfg.name}: {cfg.n_layers} layers at full width "
        f"(d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} "
        f"of {cfg.head_dim}, GeGLU {cfg.d_ff}, vocab {cfg.vocab} tied), "
        f"{n_params} parameters drawn in bf16 on the card in {init_s:.3f} s; "
        f"{PALI_BATCH} requests of {n_patch} patch rows x {feature_dim(cfg)} "
        f"+ {PALI_TEXT} tokens as one batch, {PALI_NEW} greedy tokens each "
        f"(make_prefill_step + make_decode_step(return_logits=False) from "
        f"position {pos0}); tokens repeat on a second run; launches {moved}; "
        f"the prefill ran {flash}; first request's tokens {got[0].tolist()}")
    log(f"phase 10b: {cfg.name} on {card}: first run {first_wall:.3f} s, "
        f"second {wall:.3f} s ({PALI_BATCH * PALI_NEW / wall:.1f} tokens/s of "
        f"wall); warm prefill (B = {PALI_BATCH}, {pos0} positions) wall "
        f"{sorted(pre)[1] * 1e3:.3f} ms (median of 3); warm step (B = "
        f"{PALI_BATCH}, tokens read back) wall {sorted(steps)[2] * 1e3:.3f} "
        f"ms (median of 5); peak device memory {peak:.3f} GiB")
    log(f"phase 10b: {cfg.name}: " + profile_line("one warm prefill", p_wall,
                                                  p_busy, p_kernels))
    log(f"phase 10b: {cfg.name}: " + profile_line("one warm decode step",
                                                  *step_profile))
    del model, tree, cache
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    t0 = time.perf_counter()
    cut_errs, cut_tree = card_against_cpu(torch, np, dev, cut, cfg.name,
                                          patches=n_patch)
    log(f"phase 10b: {cfg.name}: 2-layer full-width f32 cut, "
        f"{sum(t.numel() for _, t in leaves_with_path(cut_tree)) * 4 / 1e9:.1f} "
        f"GB, {n_patch} patch rows before each 64-token prompt, card vs CPU: "
        f"greedy tokens equal over prefill + 4 decode steps; logits error / "
        f"max |logit| " + ", ".join(f"{x_:.3g}" for x_ in cut_errs)
        + f"; {time.perf_counter() - t0:.1f} s")
    del cut_tree
    return moved


def check_train_launches(moved, what, cfg, steps):
    """Every kernel of ours launched as :func:`train_launches` says, and no
    other."""
    want = train_launches(cfg, steps)
    for name in KERNELS:
        check(moved[name] == want.get(name, 0), f"{what}: launched {name} "
              f"{moved[name]} times, expected {want.get(name, 0)}")


def train_kernel_names(cfg) -> tuple:
    """Name fragments of the device kernels of ours a train step of ``cfg``
    runs besides the norm's: the flash forward and backward where it has
    attention, each recurrent block's scan forward and backward."""
    kinds = set(layer_kinds(cfg))
    names = (FLASH_KERNEL_NAMES + FLASH_BWD_KERNEL_NAMES
             if kinds & {"attn", "mla"} else ())
    for kind, pair in SCAN_KERNEL_NAMES.items():
        if kind in kinds:
            names += pair
    return names


def check_train_kernels(per_kernel, counts, what, cfg):
    """A profiled train step ran the hand-written forward and backward
    kernels of ``cfg``'s route and no other: bf16 at the tensor-core head
    dims (``MMA_HEAD_DIMS``, ``bwd_route``) ``flash_wgmma_kernel`` and
    ``flash_{dq,dkdv}_wgmma_kernel``, else ``flash_kernel`` and the
    CUDA-core ``flash_{dq,dkdv}_kernel``, each once an attention layer
    (``counts``, the profiler's events by name); an rwkv or mamba block's
    scan forward and backward kernels once a layer of its kind; the norm
    kernel; and no library attention kernel (SDPA's forward or backward:
    flash, memory-efficient or cuDNN).  -> the kernels' names."""
    import torch
    from repro_torch.kernels.flash_attention.flash_attention import (
        MMA_HEAD_DIMS, bwd_route)
    check(any(n in k for k in per_kernel for n in NORM_KERNEL_NAMES),
          f"{what}: the profiled step ran no norm kernel")
    library = [k for k in per_kernel
               if any(t in k.lower() for t in LIBRARY_ATTENTION)]
    check(not library, f"{what}: the step ran library attention kernels: "
          f"{library}")
    kinds = layer_kinds(cfg)
    ours = sorted(k[k.index(n):].split("(")[0] for k in per_kernel
                  for n in train_kernel_names(cfg) if n in k)
    for kind, (fwd, bwd) in SCAN_KERNEL_NAMES.items():
        for name in (fwd, bwd):
            ran = sum(c for k, c in counts.items() if name in k)
            check(ran == kinds.count(kind),
                  f"{what}: {ran} launches of {name} in the profiled step, "
                  f"expected one a {kind} layer ({kinds.count(kind)})")
    attn = kinds.count("attn") + kinds.count("mla")
    if not attn:
        return ours
    dims = attn_dims(cfg)
    dtype = getattr(torch, cfg.dtype)
    mma = dtype == torch.bfloat16 and dims in MMA_HEAD_DIMS
    wgmma = bwd_route(dtype, *dims) == "wgmma"
    # (the forward's names list the CUDA-core kernel first, the
    # backward's the tensor-core one)
    for names, want in ((FLASH_KERNEL_NAMES, FLASH_KERNEL_NAMES[mma]),
                        (FLASH_BWD_DQ_NAMES, FLASH_BWD_DQ_NAMES[not wgmma]),
                        (FLASH_BWD_DKDV_NAMES,
                         FLASH_BWD_DKDV_NAMES[not wgmma])):
        ran = {k: c for k, c in counts.items()
               if any(n in k for n in names)}
        check(bool(ran) and all(want in k for k in ran),
              f"{what}: the profiled step ran {sorted(ran)}, expected only "
              f"{want}")
        check(sum(ran.values()) == attn,
              f"{what}: {sum(ran.values())} launches of {want} in the "
              f"profiled step, expected one an attention layer ({attn})")
    return ours


class plain_scan_guard:
    """Within the block, count every call of the scans' plain versions
    (``rwkv6_scan_plain``, ``mamba_scan_plain`` and their backwards, as the
    ops modules reach them) on CUDA tensors: on the card the ops launch the
    kernels or raise, and a training phase shows that they did by finding
    ``calls`` empty."""

    def __enter__(self):
        from repro_torch.kernels.mamba_scan import ops as mamba_ops
        from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
        self.calls = {}
        self.kept = []
        for mod, names in ((rwkv_ops, ("rwkv6_scan_plain",
                                       "rwkv6_scan_bwd_plain")),
                           (mamba_ops, ("mamba_scan_plain",
                                        "mamba_scan_bwd_plain"))):
            for name in names:
                fn = getattr(mod, name)
                self.kept.append((mod, name, fn))
                setattr(mod, name, self._counting(name, fn))
        return self

    def _counting(self, name, fn):
        def counted(*args, **kwargs):
            if args[0].device.type == "cuda":
                self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return counted

    def __exit__(self, *exc):
        for mod, name, fn in self.kept:
            setattr(mod, name, fn)
        return False


def train_shape(cfg) -> str:
    """``cfg``'s widths, for the training phases' logs."""
    kinds = set(layer_kinds(cfg))
    moe_layers = sum(m == "moe" for m in cfg.mlp_pattern) * cfg.n_groups
    parts = [f"d_model {cfg.d_model}"]
    if kinds & {"attn", "mla"}:
        dk, dv = attn_dims(cfg)
        parts.append(f"{cfg.n_heads} heads of Dk {dk} / Dv {dv}")
    if "rwkv" in kinds:
        parts.append(f"{cfg.rwkv_heads} rwkv heads of {cfg.rwkv_head_dim}")
    if "mamba" in kinds:
        parts.append(f"Mamba d_inner {cfg.mamba_d_inner}, d_state "
                     f"{cfg.mamba_d_state}, dt_rank {cfg.mamba_dt_rank}")
    if moe_layers:
        parts.append(f"{moe_layers} MoE layers of {cfg.n_experts} experts of "
                     f"{cfg.d_ff_expert}, top-{cfg.top_k}, "
                     f"{cfg.n_shared_experts} shared")
    elif cfg.n_groups:
        parts.append(f"d_ff {cfg.d_ff}")
    if cfg.first_layer_dense:
        parts.append(f"a dense first layer (d_ff {cfg.d_ff_dense or cfg.d_ff})")
    if cfg.frontend != "none":
        parts.append(f"{cfg.frontend} frontend")
    parts.append(f"vocab {cfg.vocab}")
    return ", ".join(parts)


def train_full(torch, np, dev, cfg, card, phase="11a"):
    """Phase 11a (11d-11i): ``cfg`` (stablelm-1.6b; moonshot-v1-16b-a3b and
    deepseek-v2-236b cut in depth, hubert-xlarge, paligemma-3b and
    rwkv6-3b whole, jamba's first layer) at full width through the
    launcher's code path (``launch.train.train_loop``, as ``python -m
    repro_torch.launch.train --steps 5`` runs it: batch 8, seq 128, f32
    masters drawn on the card from seed 0, bf16 compute, bf16 moments, remat
    "none", WSD over the 5 steps), with the launch counters reset just
    before and read just after: each kernel of ours as
    :func:`train_launches` says (the flash or scan forward and backward
    once a layer a step), nothing else of ours, and no plain scan called on
    the card (:class:`plain_scan_guard`); every
    loss finite, the first within 0.5 of ln V + 1/2 (the expected
    cross-entropy of logits of variance 1: a normed hidden state against an
    lm_head drawn with variance 1/d) plus, for an MoE stack, the aux
    losses' share at a uniform routing (0.01 x a load balance of 1, 0.001 x
    a router z of (ln E)^2 a layer); with tied embeddings (paligemma) at
    least that less 0.5, and the last loss below the first.  Then the
    walls: a trainer from ``build_host_trainer`` steps once warm, three timed steps (host clock to
    a synchronize) and one profiled (busy, idle share, kernels by name and
    count: the hand-written forward and backward kernels of ``cfg``'s route
    once a layer, no library attention), peak device memory.  -> the
    counted run's launches."""
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.kernels import common
    from repro_torch.launch.train import build_host_trainer, train_loop
    from repro_torch.models.params import leaves_with_path, map_tree
    from repro_torch.models.transformer import AUX_LB_COEF, AUX_Z_COEF
    from repro_torch.train.step import TrainConfig
    tcfg = TrainConfig(peak_lr=3e-4, total_steps=TRAIN_STEPS, remat="none",
                       microbatches=1)
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    with plain_scan_guard() as guard:
        state, losses = train_loop(cfg, tcfg, steps=TRAIN_STEPS,
                                   global_batch=TRAIN_BATCH,
                                   seq_len=TRAIN_SEQ, seed=0, device=dev)
    torch.cuda.synchronize()
    loop_wall = time.perf_counter() - t0
    del state
    moved = dict(common.LAUNCHES)
    check_train_launches(moved, f"{cfg.name} train_loop", cfg,
                         TRAIN_STEPS)
    check(not guard.calls, f"{cfg.name} train_loop: plain scans ran on the "
          f"card: {guard.calls}")
    moe_layers = sum(m == "moe" for m in cfg.mlp_pattern) * cfg.n_groups
    expect = math.log(cfg.vocab) + 0.5 + moe_layers * (
        AUX_LB_COEF + AUX_Z_COEF * math.log(max(cfg.n_experts, 1)) ** 2)
    check(all(math.isfinite(x) for x in losses),
          f"{cfg.name}: a loss is not finite: {losses}")
    if cfg.tie_embeddings:
        # a tied head is not independent of the hidden state, which carries
        # the input token's own embedding: that token's logit lifts the
        # first loss above ln V + 1/2 by an amount no formula here gives
        # (paligemma: 14.18 against 12.96), so the loss must lie above it
        # and fall over the steps
        check(losses[0] >= expect - 0.5 and losses[-1] < losses[0],
              f"{cfg.name}: first loss {losses[0]} is below ln V + 1/2 = "
              f"{expect} less 0.5, or the last {losses[-1]} is not below it")
    else:
        check(abs(losses[0] - expect) <= 0.5,
              f"{cfg.name}: first loss {losses[0]} is not within 0.5 of "
              f"ln V + 1/2 (+ the aux losses' share) = {expect}")
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    step_fn, state, _ = build_host_trainer(cfg, tcfg, 0, device=dev)
    n_params = sum(t.numel() for _, t in leaves_with_path(state["params"]))
    data = SyntheticLMData(DataConfig(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab), cfg)

    def one(i):
        batch = map_tree(lambda a: torch.from_numpy(a).to(dev),
                         data.batch_at(i))
        return step_fn(state, batch)[1]["loss"]

    t0 = time.perf_counter()
    one(0)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    walls = []
    for i in range(1, 4):
        t0 = time.perf_counter()
        one(i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    names = train_kernel_names(cfg)
    per_step = train_launches(cfg, 1)
    # the flash backward is two device kernels a layer
    want = (per_step.get("flash_attention", 0) * 3
            + sum(per_step.get(k, 0) for k in ("rwkv6_scan", "rwkv6_scan_bwd",
                                                "mamba_scan",
                                                "mamba_scan_bwd")))
    p_wall, p_busy, p_kernels, counts = profile_ours(
        torch, lambda: one(4), names, want,
        f"phase {phase}: {cfg.name}'s profiled step")
    ran = check_train_kernels(p_kernels, counts, cfg.name, cfg)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_wall = sorted(walls)[1]
    bwd_names = FLASH_BWD_KERNEL_NAMES + tuple(
        pair[1] for pair in SCAN_KERNEL_NAMES.values())
    bwd_us = sum(v for k, v in p_kernels.items()
                 if any(n in k for n in bwd_names))
    fwd_us = sum(v for k, v in p_kernels.items()
                 if any(n in k for n in names)
                 and not any(n in k for n in bwd_names))
    our_counts = {kernel_name(k) + k[k.index("<"):k.index(">") + 1]: c
                  for k, c in counts.items() if any(n in k for n in names)}
    log(f"phase {phase}: {cfg.name}: {cfg.n_layers} layers at full width "
        f"({train_shape(cfg)}), {n_params} f32 parameters; "
        f"train_loop {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens in {loop_wall:.3f} s, losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f" (expected first {expect:.4f}); launches {moved} "
        f"(a step: {per_step}); no plain scan called on the card")
    log(f"phase {phase}: {cfg.name} on {card}: first step {first_wall:.3f} s; "
        f"warm step wall {step_wall * 1e3:.3f} ms (median of 3; "
        + ", ".join(f"{w * 1e3:.3f}" for w in walls)
        + f"), {TRAIN_BATCH * TRAIN_SEQ / step_wall:.1f} tokens/s; peak "
        f"device memory {peak:.3f} GiB ({before:.3f} GiB allocated before "
        f"the trainer was built); hand-written kernels in the "
        f"profiled step: forward {fwd_us / 1e3:.4f} ms, backward "
        f"{bwd_us / 1e3:.4f} ms; device launches a step {our_counts} "
        f"({ran})")
    log(f"phase {phase}: {cfg.name}: " + profile_line(
        "one warm train step", p_wall, p_busy, p_kernels))
    for kind, bwd_kernels in SCAN_BWD_KERNEL_NAMES.items():
        if kind not in layer_kinds(cfg):
            continue
        ran = {kernel_name(k): (counts[k], v) for k, v in p_kernels.items()
               if any(n in k for n in bwd_kernels)}
        scan_us = sum(v for _, v in ran.values())
        log(f"phase {phase}: {cfg.name}: the {kind} scan's backward in the "
            f"profiled step: " + ", ".join(
                f"{k} {c} launches {v / 1e3:.4f} ms" for k, (c, v) in ran.items())
            + f"; {scan_us / 1e3:.4f} ms, {scan_us * 1e-6 / p_busy:.4f} of "
            f"the busy time")
    del state, step_fn
    torch.cuda.empty_cache()
    return moved


def routes_match(torch, cut, card_routes, cpu_routes):
    """Every MoE routing group's slots on the card ``==`` the CPU's (f32
    router products in another summation order); on a difference, the first
    token that parts, its slots and the gap in router logits between its
    k-th choice and the next on the CPU."""
    check(len(card_routes) == len(cpu_routes),
          f"{cut.name} cut: {len(card_routes)} routing calls on the card, "
          f"{len(cpu_routes)} on the CPU")
    k = cut.top_k
    for layer, ((cs, _), (ws, wl)) in enumerate(zip(card_routes, cpu_routes)):
        cs = cs.cpu()
        if torch.equal(cs, ws):
            continue
        n, a = map(int, (cs != ws).nonzero()[0])
        tok = a // k
        top = torch.sort(wl[n, tok].double(), descending=True).values
        raise SmokeFailure(
            f"{cut.name} cut: MoE layer {layer}, group {n}, token {tok} routes "
            f"to slots {cs[n, tok * k:(tok + 1) * k].tolist()} on the card, "
            f"{ws[n, tok * k:(tok + 1) * k].tolist()} on the CPU; its gap "
            f"between choice {k} and {k + 1} in router logits on the CPU "
            f"{float(top[k - 1] - top[k]):.3g}")
    return sum(int(w.numel()) for w, _ in cpu_routes)


def train_cut(torch, np, dev, base, card, *, n_layers=2, batch=2,
              steps=True, phase="11a"):
    """Phase 11a's cut (and 11d-11g's): ``base`` at full width,
    ``n_layers`` layers, f32, the same parameters (drawn on the CPU, seed 0)
    and batch (``batch`` x 128 tokens) on the card and the CPU.  An MoE
    stack's routing first: every group's slots equal (:func:`routes_match`).
    The card's f32 products (TF32 off) and kernels sum in another order
    than the CPU's: the loss, ``load_balance`` and ``router_z`` within 1e-5
    relative, every leaf's gradient within 1e-4 of that leaf's max |g| (the
    CPU tests' rule against the JAX package); ``remat="dots"`` and
    ``"full"`` give the card's gradients bit for bit.  With ``steps``, after
    two train steps (launcher defaults, a constant lr of 3e-4, so both steps
    move the parameters: WSD's first step has lr 0) each bf16 moment leaf
    within one bf16 ulp in norm, ``|m_card - m_cpu| <= 2^-7 |m_cpu|`` (the
    gradients agree to 1e-4 of their max, and a moment rounded to bf16 can
    land one ulp apart; taken element by element, the elements of a
    near-zero leaf such as the key bias's are rounding noise); and the
    parameters within 1e-5 of each leaf's max |p| plus twice the summed
    learning rates element by element (Adam scales a near-zero gradient's
    rounding noise to a whole step, of either sign) and plus 3 % of that
    sum on average over each leaf (but the key bias ``bk``, whose gradient
    is zero in exact arithmetic: softmax ignores a shift common to a
    query's scores)."""
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models import moe as moe_module
    from repro_torch.models.params import init_params, leaves_with_path, map_tree
    from repro_torch.models.transformer import Transformer, bind_grads, model_spec
    from repro_torch.optim import adamw_init, constant_schedule
    from repro_torch.train.step import TrainConfig, make_train_step, value_and_grad
    cut = dataclasses.replace(base, n_layers=n_layers, dtype="float32")
    t0 = time.perf_counter()
    tree = init_params(model_spec(cut), 0, device="cpu")
    data_batch = SyntheticLMData(DataConfig(batch, TRAIN_SEQ, cut.vocab),
                                 cut).batch_at(0)
    route = moe_module.route

    def grads_on(device, cfg, routes=None):
        params = map_tree(lambda t: t.to(device, copy=True), tree)
        model = Transformer(cfg, params, trainable=True)
        grads = map_tree(torch.zeros_like, params)
        bind_grads(model, grads)

        def recording(logits, cfg_, c, *, with_aux=False):
            out = route(logits, cfg_, c, with_aux=with_aux)
            routes.append((out[0].detach(), logits.detach().cpu()))
            return out

        if routes is not None:
            moe_module.route = recording
        try:
            m = value_and_grad(model, grads, map_tree(
                lambda a: torch.from_numpy(a).to(device), data_batch), cfg)
        finally:
            moe_module.route = route
        return {k: float(v) for k, v in m.items()}, grads

    cpu_routes, card_routes = [], []
    cpu_m, cpu_grads = grads_on("cpu", cut, cpu_routes)
    card_m, card_grads = grads_on(dev, cut, card_routes)
    routed = routes_match(torch, cut, card_routes, cpu_routes)
    del cpu_routes, card_routes
    for key in ("loss", "load_balance", "router_z"):
        check(abs(card_m[key] - cpu_m[key]) <= 1e-5 * abs(cpu_m[key]),
              f"{cut.name} cut: card {key} {card_m[key]} vs CPU {cpu_m[key]}")
    worst = 0.0
    for (path, g), (_, w) in zip(leaves_with_path(card_grads),
                                 leaves_with_path(cpu_grads)):
        scale = float(w.abs().max())
        e = float((g.cpu().double() - w.double()).abs().max())
        worst = max(worst, e / scale if scale else e)
        check(e <= 1e-4 * scale, f"{cut.name} cut: gradient {path}: error "
              f"{e} against max |g| {scale}")
    for remat in ("dots", "full"):
        _, remat_grads = grads_on(dev, dataclasses.replace(cut, remat=remat))
        check(all(torch.equal(a, b) for (_, a), (_, b) in zip(
            leaves_with_path(remat_grads), leaves_with_path(card_grads))),
            f"{cut.name} cut: remat={remat!r} gradients differ from "
            f"remat='none' on the card")
        del remat_grads
    del card_grads, cpu_grads
    torch.cuda.empty_cache()
    what = (f"{n_layers}-layer full-width f32 cut, card vs CPU on {batch} x "
            f"{TRAIN_SEQ} " + ("frames" if cut.frontend == "audio" else "tokens")
            + (f" ({routed} routing slots equal)" if routed else "")
            + f": loss {card_m['loss']:.6f} vs {cpu_m['loss']:.6f}, "
            f"load_balance {card_m['load_balance']:.6f} vs "
            f"{cpu_m['load_balance']:.6f}, router_z {card_m['router_z']:.6f} "
            f"vs {cpu_m['router_z']:.6f}; every gradient within 1e-4 of its "
            f"max |g| (worst {worst:.3g}); remat='dots' and 'full' gradients "
            f"bit-equal to remat='none' on the card")
    if not steps:
        log(f"phase {phase}: {base.name}: {what}; "
            f"{time.perf_counter() - t0:.1f} s")
        return

    tcfg = TrainConfig(peak_lr=3e-4, total_steps=2, remat="none")
    states, lr_sum = {}, 0.0
    for device in ("cpu", dev):
        params = map_tree(lambda t: t.to(device, copy=True), tree)
        state = {"params": params, "opt": adamw_init(params)}
        step = make_train_step(cut, tcfg, constant_schedule(3e-4))
        data = SyntheticLMData(DataConfig(batch, TRAIN_SEQ, cut.vocab), cut)
        lr_sum = 0.0
        for i in range(2):
            state, m = step(state, map_tree(
                lambda a: torch.from_numpy(a).to(device), data.batch_at(i)))
            lr_sum += float(m["lr"])
        states[str(device)] = state
    cpu_state, card_state = states["cpu"], states[str(dev)]
    moment_err = {}
    for part in ("params", "m", "v"):
        a = card_state["params"] if part == "params" else card_state["opt"][part]
        b = cpu_state["params"] if part == "params" else cpu_state["opt"][part]
        for (path, x), (_, y) in zip(leaves_with_path(a), leaves_with_path(b)):
            x, y = x.cpu().float(), y.float()
            what_ = f"{cut.name} cut: {part} {path} after 2 steps"
            if part != "params":
                rel = float(torch.linalg.vector_norm(x - y)) / max(
                    float(torch.linalg.vector_norm(y)), 1e-30)
                moment_err[part] = max(moment_err.get(part, 0.0), rel)
                check(rel <= 2.0 ** -7, f"{what_}: |error| / |leaf| {rel}")
                continue
            scale = float(y.abs().max())
            diff = (x - y).abs()
            check(float(diff.max()) <= 1e-5 * scale + 2.0 * lr_sum,
                  f"{what_}: error {float(diff.max())} against the summed lr "
                  f"{lr_sum}")
            check(path.endswith("['bk']")
                  or float(diff.mean()) <= 1e-5 * scale + 0.03 * lr_sum,
                  f"{what_}: mean error {float(diff.mean())} against the "
                  f"summed lr {lr_sum}")
    log(f"phase {phase}: {base.name}: {what}; parameters and moments after "
        f"2 steps within their tolerances (moments' worst |error| / |leaf|: "
        f"m {moment_err['m']:.3g}, v {moment_err['v']:.3g}); "
        f"{time.perf_counter() - t0:.1f} s")
    del states, card_state, cpu_state
    torch.cuda.empty_cache()


def train_example(torch, np, dev, card):
    """Phase 11b: the ~86M model of ``examples/train_lm_torch.py`` on the
    card through ``train_loop``, as the example runs it (150 steps of 4 x 64
    tokens, peak lr 3e-3), with the launch counters reset before and read
    after: the loss falls by 0.5 or more.  Then the checkpoint restart of
    ``tests/test_integration.py``: 24 steps uninterrupted; 24 steps with
    checkpoints every 8 that exit (``SystemExit`` 42) after step 16; a
    resumed run from the latest checkpoint (step 17), whose losses must be
    the uninterrupted run's bit for bit.  -> the counted run's launches."""
    import shutil
    from repro_torch.configs import example_config
    from repro_torch.kernels import common
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainConfig
    cfg = example_config()
    t0 = time.perf_counter()
    common.reset_launches()
    _, losses = train_loop(cfg, TrainConfig(peak_lr=3e-3,
                                            total_steps=EXAMPLE_STEPS,
                                            remat="none"),
                           steps=EXAMPLE_STEPS, global_batch=EXAMPLE_BATCH,
                           seq_len=EXAMPLE_SEQ, log_every=50, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moved = dict(common.LAUNCHES)
    check_train_launches(moved, f"{cfg.name} train_loop", cfg,
                         EXAMPLE_STEPS)
    check(losses[-1] < losses[0] - 0.5,
          f"{cfg.name}: the loss fell from {losses[0]} to {losses[-1]}, less "
          f"than 0.5")
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    tcfg = TrainConfig(peak_lr=1e-3, total_steps=30, remat="none")
    kw = dict(steps=24, global_batch=4, seq_len=32, seed=1, device=dev)
    t1 = time.perf_counter()
    _, gold = train_loop(cfg, tcfg, **kw)
    try:
        train_loop(cfg, tcfg, simulate_failure=16, ckpt_dir=str(ckpt),
                   ckpt_every=8, **kw)
    except SystemExit as e:
        check(e.code == 42, f"{cfg.name}: the simulated failure exited "
              f"with {e.code}, expected 42")
    else:
        raise SmokeFailure(f"{cfg.name}: simulate_failure=16 did not exit")
    _, resumed = train_loop(cfg, tcfg, ckpt_dir=str(ckpt), ckpt_every=8, **kw)
    shutil.rmtree(ckpt, ignore_errors=True)
    check(resumed == gold[17:], f"{cfg.name}: the resumed losses "
          f"{resumed} differ from the uninterrupted run's {gold[17:]}")
    log(f"phase 11b: {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}) on "
        f"{card}: {EXAMPLE_STEPS} steps of {EXAMPLE_BATCH} x {EXAMPLE_SEQ} "
        f"tokens in {wall:.3f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(ln V = {math.log(cfg.vocab):.4f}); launches {moved}; killed after "
        f"step 16 and resumed from the step-17 checkpoint: losses of steps "
        f"17..23 bit-equal to the uninterrupted run's "
        f"({time.perf_counter() - t1:.1f} s)")
    torch.cuda.empty_cache()
    return moved


def encode_hubert(torch, np, dev, cfg, card):
    """Phase 11c: hubert-xlarge's encode (``make_prefill_step`` of an
    encoder: ``forward`` without a gradient, then the per-frame logits) at
    full width and depth on a bf16 tree drawn on the card (seed 0),
    :data:`ENCODE_BATCH` x :data:`ENCODE_FRAMES` frames of 512 features
    (numpy seed 3), with the launch counters reset before a second call and
    read after it: ``flash_attention`` once a layer (non-causal, Dv 80, on
    ``flash_wgmma_kernel<80, 80>``), ``norm`` at every norm (the
    frontend's included), nothing else of ours, no library
    attention kernel; the second call's logits bit-equal to the first's.
    Then a 2-layer f32 cut, the card against the CPU on 2 x 64 frames:
    logits within 1e-4 of max |logit| (the prefill rule).  -> the counted
    call's launches."""
    from repro_torch.kernels import common
    from repro_torch.models.params import init_params, leaves_with_path, map_tree
    from repro_torch.models.transformer import Transformer, model_spec
    from repro_torch.train.serve import make_prefill_step
    tree = init_params(model_spec(cfg), 0, dtype=torch.bfloat16, device=dev)
    model = Transformer(cfg, tree)
    n_params = sum(t.numel() for _, t in leaves_with_path(tree))
    frames = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (ENCODE_BATCH, ENCODE_FRAMES, 512)).astype(np.float32)).to(dev)
    encode = make_prefill_step(cfg, ENCODE_FRAMES)
    first = encode(model, {"frames": frames})
    torch.cuda.synchronize()
    common.reset_launches()
    got = encode(model, {"frames": frames})
    torch.cuda.synchronize()
    moved = dict(common.LAUNCHES)
    want = model_launches(cfg, 1, 0, flash_attention=cfg.n_layers)
    for name in KERNELS:
        check(moved[name] == want.get(name, 0), f"{cfg.name}: the encode "
              f"launched {name} {moved[name]} times, expected "
              f"{want.get(name, 0)}")
    check(got.shape == (ENCODE_BATCH, ENCODE_FRAMES, cfg.vocab_padded)
          and got.dtype == torch.float32 and bool(torch.isfinite(
              got[..., :cfg.vocab]).all()),
          f"{cfg.name}: encode logits are not finite f32 of shape "
          f"({ENCODE_BATCH}, {ENCODE_FRAMES}, {cfg.vocab_padded})")
    check(torch.equal(first, got), f"{cfg.name}: a second encode differs")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        encode(model, {"frames": frames})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    p_wall, p_busy, p_kernels = device_profile(
        torch, lambda: encode(model, {"frames": frames}))
    library = [k for k in p_kernels
               if any(t in k.lower() for t in LIBRARY_ATTENTION)]
    check(not library, f"{cfg.name}: the encode ran library attention "
          f"kernels: {library}")
    flash = sorted(k for k in p_kernels
                   if any(n in k for n in FLASH_KERNEL_NAMES))
    check(bool(flash) and all("flash_wgmma_kernel<80, 80>" in k
                              for k in flash),
          f"{cfg.name}: the encode ran {flash}, expected "
          f"flash_wgmma_kernel<80, 80>")
    log(f"phase 11c: {cfg.name}: {cfg.n_layers} layers at full width "
        f"(d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, "
        f"bidirectional, GELU {cfg.d_ff}), {n_params} parameters in bf16; "
        f"encode of {ENCODE_BATCH} x {ENCODE_FRAMES} frames on {card}: "
        f"wall {sorted(walls)[1] * 1e3:.3f} ms (median of 3), "
        f"{ENCODE_BATCH * ENCODE_FRAMES / sorted(walls)[1]:.1f} frames/s; "
        f"launches {moved}; bit-equal on a second call")
    log(f"phase 11c: {cfg.name}: " + profile_line("one warm encode", p_wall,
                                                 p_busy, p_kernels))
    del model, tree
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    t0 = time.perf_counter()
    cut_tree = init_params(model_spec(cut), 0, device="cpu")
    small = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 64, 512)).astype(np.float32))
    cut_encode = make_prefill_step(cut, 64)
    want = cut_encode(Transformer(cut, cut_tree), {"frames": small})
    got = cut_encode(Transformer(cut, map_tree(lambda t: t.to(dev), cut_tree)),
                     {"frames": small.to(dev)}).cpu()
    want, got = want[..., :cut.vocab], got[..., :cut.vocab]   # no padding
    scale = float(want.abs().max())
    e = float((got.double() - want.double()).abs().max())
    check(e <= 1e-4 * scale, f"{cfg.name} cut: card vs CPU logits error {e} "
          f"against max |logit| {scale}")
    log(f"phase 11c: {cfg.name}: 2-layer full-width f32 cut, card vs CPU on "
        f"2 x 64 frames: logits error / max |logit| {e / scale:.3g}; "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return moved


#: phase 12a's sharded lanes: (label, mesh positions, max_batch, shards
#: a micro-batch launch splits into)
SHARDED_LANES = (("one position", 1, 4, 1), ("two positions", 2, 4, 2),
                 ("max_batch=3 fallback", 2, 3, 1))
SHARDED_REQUESTS = 16
#: the TinyBio kernels' device function names, by counter name
TINYBIO_DEVICE_NAMES = {"fir": "fir_kernel", "delineate": "delineate_kernel",
                        "stockham_fft": "stockham_fft_kernel",
                        "svm": "svm_kernel"}
#: phase 12b's gradient leaf: this arch's embedding (vocab x d_model, f32)
PSUM_ARCH = "stablelm-1.6b"


class VClock:
    """A virtual clock: the serving timeline becomes the machine model's,
    so reports of two runs compare with ==."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def modeled_report(rep) -> dict:
    """Every ServeReport field but the three read on the host's clock."""
    measured = ("wall_s", "requests_per_s", "goodput_per_s")
    return {k: v for k, v in dataclasses.asdict(rep).items()
            if k not in measured}


def cp_and_t_split(torch, np, dev, card) -> None:
    """Phase 2's check of the two modes the sharded paths give the kernels,
    at full-width shapes, and their device times.

    * The context-parallel shard (``flash_attention(causal=True,
      q_offset=)``, the call each shard of the model's path makes): paligemma-3b's
      heads (B 1, 8 over one kv head of 256), q of S_local = 512 rows
      against T = 8192 keys at ``q_offset`` 0, 512 x 7 and 512 x 15 (a
      16-way model axis over S = 8192), bf16 and f32: the forward kernel
      against ``flash_attention_plain`` at that offset, the backward
      kernels (through the autograd call) against autograd of the plain
      version in f32, each with phase 2's tolerances (1e-5 of max, plus a
      bf16 ulp of each value in bf16).
    * The T-split decode (``decode_max``, ``decode_partial``,
      ``combine_shards``): qwen's step (B 4, H 16 over 2 kv heads of 128,
      T 512, lengths 257 .. 272, bf16) split into 4 T-blocks, the last of
      which holds no key of any row: its max is the sentinel and its
      partial zero; the combined step against the unsplit ``lengths`` call
      (within 1e-5 of max |v| plus 2^-9 of it for the bf16 weights and a
      bf16 ulp of each output) and against the plain two-pass version
      (``decode_max_ref``, ``decode_partial_ref``) to the same tolerance;
      the passes each one launch.

    Then device times (CUDA graphs): the shard's backward at 512 x 15
    (bf16) beside its bound and SDPA's backward with an explicit mask of
    the same visibility, and the two decode passes over one T-block beside
    their byte bounds (no library call computes them)."""
    import torch.nn.functional as F
    from repro_torch.configs import get as get_arch
    from repro_torch.kernels import common
    from repro_torch.kernels.decode_attention.ops import (
        combine_shards, decode_attention, decode_max, decode_partial)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_masked_ref, decode_max_ref, decode_partial_ref)
    from repro_torch.kernels.flash_attention.ops import (
        _card_forward, flash_attention, flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain, flash_attention_plain)
    bf16 = torch.bfloat16
    pali = get_arch("paligemma-3b")
    h, kvh, d = pali.n_heads, pali.n_kv_heads, pali.head_dim
    s_local, t = 512, 8192
    gen = torch.Generator(device=dev).manual_seed(5)

    def normal(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def err(a, b):
        return float((a.double() - b.double()).abs().max().item())

    def within(got, want, dtype, what):
        g, w = got.float(), want.float()
        tol = 1e-5 * float(w.abs().max())
        if dtype == bf16:
            tol = tol + 2.0 ** -7 * torch.maximum(g.abs(), w.abs())
        check(bool(((g - w).abs() <= tol).all())
              and bool(torch.isfinite(g).all()), f"{what}: error {err(got, want)}")
        return err(got, want)

    cp_err = {}
    offsets = (0, s_local * 7, s_local * 15)
    for dtype in (bf16, torch.float32):
        q = normal(1, h, s_local, d, dtype=dtype)
        k = normal(1, kvh, t, d, dtype=dtype)
        v = normal(1, kvh, t, d, dtype=dtype)
        dout = normal(1, h, s_local, d, dtype=dtype)
        for off in offsets:
            what = f"context-parallel shard {str(dtype)[6:]} q_offset {off}"
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            before = dict(common.LAUNCHES)
            out = flash_attention(*leaves, causal=True, scale=d ** -0.5,
                                  q_offset=off)
            got = torch.autograd.grad(out, leaves, dout)
            torch.cuda.synchronize()
            check(common.LAUNCHES["flash_attention"] == before[
                "flash_attention"] + 1 and common.LAUNCHES[
                "flash_attention_bwd"] == before["flash_attention_bwd"] + 1,
                f"{what}: the forward and backward kernels did not launch "
                f"once each")
            want = flash_attention_plain(q, k, v, causal=True, q_offset=off)
            cp_err[what + " out"] = within(out.detach(), want, dtype,
                                           what + " out")
            want_g = flash_attention_bwd_plain(
                q.float(), k.float(), v.float(), dout.float(), causal=True,
                q_offset=off)
            for name, g, w in zip("qkv", got, want_g):
                check(g.dtype == dtype and g.shape == w.shape,
                      f"{what}: d{name} dtype or shape")
                cp_err[f"{what} d{name}"] = within(g, w, dtype,
                                                   f"{what} d{name}")
    log("phase 2: context-parallel flash (q_offset) ok, forward and backward "
        "kernels against the plain version at paligemma's heads (B=1 H=8 "
        "KVH=1 D=256), S_local=512 of T=8192: max abs err "
        + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in cp_err.items()))

    # the shard's backward at q_offset 512 x 15, bf16: device time, bound,
    # SDPA's backward with the shard's mask
    off = offsets[-1]
    q, k, v, dout = (x.contiguous() for x in (
        normal(1, h, s_local, d, dtype=bf16), normal(1, kvh, t, d, dtype=bf16),
        normal(1, kvh, t, d, dtype=bf16), normal(1, h, s_local, d, dtype=bf16)))
    _, lse = _card_forward(q, k, v, True, d ** -0.5, off, s_local, 512,
                           with_lse=True)
    pairs = sum(min(t, off + i + 1) for i in range(s_local))
    nbytes = 2.0 * (2 * h * s_local * d * 2 + 2 * kvh * t * d * 2)
    cp_bound = bound(nbytes, 2.0 * h * pairs * 5 * d, PEAK_BF16_FLOPS)
    mask = (off + torch.arange(s_local, device=dev)[:, None]
            >= torch.arange(t, device=dev)[None])
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                           enable_gqa=True)
        return torch.autograd.grad(o, (qg, kg, vg), dout)

    lib_fb = device_ms(torch, sdpa_fwd_bwd, 5)
    lib_f = device_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True), 5)
    cp_ms = device_ms(torch, lambda: flash_attention_bwd(
        q, k, v, dout, lse, q_offset=off), 10)
    plain_ms = device_ms(torch, lambda: flash_attention_bwd_plain(
        q, k, v, dout, q_offset=off), 1, replays=3)
    log(f"phase 2: flash_attention_bwd at q_offset {off} (context-parallel "
        f"shard, paligemma heads B=1 H={h} KVH={kvh} S_local={s_local} "
        f"T={t} D={d} bf16) on {card}: kernel {cp_ms:.6f} ms, plain "
        f"{plain_ms:.6f} ms, library (SDPA backward with the shard's mask: "
        f"forward + backward {lib_fb:.6f} less forward {lib_f:.6f}) "
        f"{lib_fb - lib_f:.6f} ms; bound {cp_bound[0]:.6f} ms "
        f"({cp_bound[1]}: {pairs} visible pairs a head); kernel "
        f"{cp_ms / cp_bound[0]:.1f}x its bound")

    # the T-split decode step: qwen's, 4 blocks of 128 keys
    lm = get_arch(LM_ARCH)
    b, hq, hk, d2 = LM_BATCH, lm.n_heads, lm.n_kv_heads, lm.head_dim
    tt, n = LM_MAX_LEN, 4
    q = normal(b, hq, d2, dtype=bf16)
    k = normal(b, hk, tt, d2, dtype=bf16)
    v = normal(b, hk, tt, d2, dtype=bf16)
    lens = torch.tensor([257, 262, 267, 272][:b], device=dev)
    tl = tt // n
    blocks = [(k[:, :, i * tl:(i + 1) * tl], v[:, :, i * tl:(i + 1) * tl],
               (lens - i * tl).clamp(0, tl)) for i in range(n)]
    before = common.LAUNCHES["decode_attention"]
    maxima = [decode_max(q, kb, lb) for kb, _, lb in blocks]
    m = torch.stack(maxima).amax(0)
    parts = [decode_partial(q, kb, vb, lb, m) for kb, vb, lb in blocks]
    got = combine_shards(parts, bf16)
    torch.cuda.synchronize()
    check(common.LAUNCHES["decode_attention"] == before + 2 * n,
          "T-split decode: each pass did not launch once a block")
    check(bool((maxima[-1] == -1e30).all()) and bool(
        (parts[-1][1] == 0).all()) and bool((parts[-1][0] == 0).all()),
          "T-split decode: the block past every row's length does not give "
          "the sentinel max and a zero partial")
    plain_m = torch.stack([decode_max_ref(q, kb, lb)
                           for kb, _, lb in blocks]).amax(0)
    plain = combine_shards([decode_partial_ref(q, kb, vb, lb, plain_m)
                            for kb, vb, lb in blocks], bf16)
    unsplit = decode_attention(q, k, v, lengths=lens)
    vmax = float(v.float().abs().max())
    t_err = {}
    for what, want in (("unsplit lengths call", unsplit),
                       ("plain two-pass", plain),
                       ("masked plain", decode_attention_masked_ref(
                           q, k, v, lens))):
        tol = (1e-5 + 2.0 ** -9) * vmax + 2.0 ** -7 * torch.maximum(
            got.float().abs(), want.float().abs())
        t_err[what] = err(got, want)
        check(bool(((got.float() - want.float()).abs() <= tol).all()),
              f"T-split decode against the {what}: error {t_err[what]}")
    check(err(m, plain_m) <= 1e-5 * float(plain_m.abs().max()),
          f"T-split decode: the row maxima differ from the plain pass's by "
          f"{err(m, plain_m)}")
    log(f"phase 2: T-split decode ok (qwen's step B={b} H={hq} KVH={hk} "
        f"T={tt} D={d2} bf16, lengths {lens.tolist()}, 4 blocks of {tl}, the "
        f"last holding no key: sentinel max, zero partial; the row maxima "
        f"within {err(m, plain_m):.3g} of the plain pass's; max abs err "
        + ", ".join(f"vs the {k_} {v_:.3g}" for k_, v_ in t_err.items()) + ")")
    kb, vb, lb = blocks[2]                  # keys 256 .. 383: every row has some
    n_keys = int(lb.sum())
    m_bound = bound(2.0 * (n_keys * hk * d2 + b * hq * d2), 2.0 * n_keys
                    * hq * d2, PEAK_BF16_FLOPS)
    p_bound = bound(2.0 * (2 * n_keys * hk * d2 + b * hq * d2) + 4.0 * (
        b * hq * (d2 + 2)), 2.0 * n_keys * hq * 2 * d2, PEAK_BF16_FLOPS)
    max_ms = device_ms(torch, lambda: decode_max(q, kb, lb), 100)
    part_ms = device_ms(torch, lambda: decode_partial(q, kb, vb, lb, m), 100)
    max_plain = device_ms(torch, lambda: decode_max_ref(q, kb, lb), 10)
    part_plain = device_ms(torch, lambda: decode_partial_ref(q, kb, vb, lb, m),
                           10)
    log(f"phase 2: T-split decode passes over one block (keys 256 .. 383, "
        f"lengths {lb.tolist()}) on {card}: max pass kernel {max_ms:.6f} ms, "
        f"plain {max_plain:.6f} ms, bound {m_bound[0]:.6f} ms ({m_bound[1]}); "
        f"partial pass kernel {part_ms:.6f} ms, plain {part_plain:.6f} ms, "
        f"bound {p_bound[0]:.6f} ms ({p_bound[1]}); library: none computes "
        f"either pass")


def sharded_models(torch, np, dev, card, lm_ref) -> dict:
    """Phase 12c: the models under sharding rules on ``make_host_mesh()``
    (NCCL, world 1), every tensor a DTensor and every kernel reached through
    ``sharding.on_blocks``.

    * stablelm-1.6b whole (phase 11a's model, batch 8 x 128, f32 masters,
      bf16 compute and moments, remat "none"): one step under
      TRAIN_FSDP_RULES (the state placed by ``param_shardings``, the FSDP
      gather in every layer) from the seed's state, against the unsharded
      step from a copy of that state: loss, every parameter and both
      moments bit-equal; the launch counts reset just before and read just
      after the sharded step (flash_attention and flash_attention_bwd once
      a layer, norm at every norm); both walls (first step on each state).
    * qwen2.5-3b at full depth, bf16 (phase 5's model from seed 0):
      prefill of phase 5's 4 x 256 prompt and 15 decode steps under
      SERVE_RULES, the launch counts read as phase 5's; the prefill logits,
      every step's logits and the greedy tokens bit-equal to phase 5's; the
      prefill and mean step walls beside phase 5's.

    -> the sharded runs' launches by kernel."""
    from repro_torch.configs import get as get_arch
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.distributed.sharding import (SERVE_RULES,
                                                  TRAIN_FSDP_RULES, activate,
                                                  distribute_tree,
                                                  param_shardings,
                                                  placements_for, spec_for)
    from repro_torch.kernels import common
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import init_params, leaves_with_path
    from repro_torch.models.transformer import Transformer, model_spec
    from repro_torch.optim.schedule import constant_schedule
    from repro_torch.train.serve import make_decode_step, make_prefill_step
    from repro_torch.train.step import (TrainConfig, clone_train_state,
                                        init_train_state, make_train_step)
    from torch.distributed.tensor import Replicate
    mesh = make_host_mesh()
    moved = {name: 0 for name in KERNELS}

    def bits(t):
        t = t.to_local() if hasattr(t, "to_local") else t
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    def place_batch(batch, rules):
        return {k_: distribute_tree(v_, placements_for(spec_for(
            ("batch", None), rules, mesh, tuple(v_.shape)), mesh), mesh)
            for k_, v_ in batch.items()}

    # -- the stablelm step under TRAIN_FSDP_RULES
    cfg = get_arch(TRAIN_ARCH)
    spec = model_spec(cfg)
    tcfg = TrainConfig(remat="none", microbatches=1)
    state = init_train_state(cfg, tcfg, 0, device=dev)
    ref = clone_train_state(state)
    batch = {k_: torch.from_numpy(v_).to(dev) for k_, v_ in SyntheticLMData(
        DataConfig(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, seed=0),
        cfg).batch_at(0).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, ref_metrics = make_train_step(cfg, tcfg, constant_schedule(3e-4))(
        ref, batch)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    psh = param_shardings(spec, TRAIN_FSDP_RULES, mesh)
    opt = state["opt"]
    placed = {"params": distribute_tree(state["params"], psh, mesh),
              "opt": {"m": distribute_tree(opt["m"], psh, mesh),
                      "v": distribute_tree(opt["v"], psh, mesh),
                      "step": distribute_tree(opt["step"],
                                              (Replicate(),) * 2, mesh)}}
    pbatch = place_batch(batch, TRAIN_FSDP_RULES)
    with activate(TRAIN_FSDP_RULES, mesh):
        step = make_train_step(cfg, tcfg, constant_schedule(3e-4))
        torch.cuda.synchronize()
        common.reset_launches()
        t0 = time.perf_counter()
        placed, metrics = step(placed, pbatch)
        torch.cuda.synchronize()
        sh_wall = time.perf_counter() - t0
    counts = dict(common.LAUNCHES)
    check_train_launches(counts, f"phase 12c {cfg.name} sharded step", cfg, 1)
    for name in KERNELS:
        moved[name] += counts[name]
    check(torch.equal(bits(metrics["loss"]), bits(ref_metrics["loss"])),
          f"phase 12c: the sharded step's loss {float(metrics['loss'].to_local())} "
          f"differs from the unsharded {float(ref_metrics['loss'])}")
    same = {}
    for part, got, want in (
            ("params", placed["params"], ref["params"]),
            ("m", placed["opt"]["m"], ref["opt"]["m"]),
            ("v", placed["opt"]["v"], ref["opt"]["v"])):
        bad = [p for (p, a), (_, b_) in zip(leaves_with_path(got),
                                             leaves_with_path(want))
               if not torch.equal(bits(a), bits(b_))]
        check(not bad, f"phase 12c: {part} leaves differ from the unsharded "
              f"step's: {bad[:4]}")
        same[part] = len(list(leaves_with_path(got)))
    log(f"phase 12c: {cfg.name} one train step under {TRAIN_FSDP_RULES.name} "
        f"on make_host_mesh() (NCCL, world 1, DTensor state) bit-equal to the "
        f"unsharded step: loss {float(ref_metrics['loss']):.6f}, "
        f"{same['params']} parameter leaves, {same['m']} + {same['v']} "
        f"moment leaves; "
        f"launches {counts}; step wall {sh_wall * 1e3:.3f} ms sharded vs "
        f"{ref_wall * 1e3:.3f} ms unsharded (first step on each state, "
        f"{card})")
    del state, ref, placed, metrics, ref_metrics, pbatch, batch, step
    torch.cuda.empty_cache()

    # -- qwen serving under SERVE_RULES
    lm = get_arch(LM_ARCH)
    spec = model_spec(lm)
    tree = init_params(spec, 0, device=dev)
    with activate(SERVE_RULES, mesh):
        model = Transformer(lm, distribute_tree(tree, param_shardings(
            spec, SERVE_RULES, mesh), mesh))
        del tree
        prefill_step = make_prefill_step(lm, LM_MAX_LEN)
        decode_fn = make_decode_step(lm)
        prompt = place_batch({"tokens": lm_ref["prompt"].to(dev)},
                             SERVE_RULES)
        torch.cuda.synchronize()
        common.reset_launches()
        t0 = time.perf_counter()
        logits, cache = prefill_step(model, prompt)
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t0
        tok = torch.argmax(logits, -1).to(torch.int32)
        steps, step_logits = [tok], []
        t0 = time.perf_counter()
        for i in range(LM_NEW - 1):
            tok, lg, cache = decode_fn(model, cache, tok, LM_PROMPT + i)
            steps.append(tok)
            step_logits.append(lg)
        torch.cuda.synchronize()
        d_wall = (time.perf_counter() - t0) / (LM_NEW - 1)
    counts = dict(common.LAUNCHES)
    want = model_launches(lm, 1, LM_NEW - 1, flash_attention=lm.n_layers)
    for name in KERNELS:
        check(counts[name] == want.get(name, 0), f"phase 12c {lm.name} "
              f"sharded serving launched {name} {counts[name]} times, "
              f"expected {want.get(name, 0)}")
        moved[name] += counts[name]
    check(torch.equal(bits(logits).cpu(), bits(lm_ref["prefill"])),
          "phase 12c: the sharded prefill's logits differ from phase 5's")
    check(all(torch.equal(bits(a).cpu(), b_) for a, b_ in zip(
        step_logits, lm_ref["steps"])),
          "phase 12c: a sharded decode step's logits differ from phase 5's")
    tokens = torch.stack([bits(x) for x in steps], 1).cpu()
    check(torch.equal(tokens, lm_ref["tokens"]),
          "phase 12c: the sharded greedy tokens differ from phase 5's")
    log(f"phase 12c: {lm.name} ({lm.n_layers} layers, bf16) under "
        f"{SERVE_RULES.name} on make_host_mesh(): prefill of "
        f"{LM_BATCH} x {LM_PROMPT} and {LM_NEW - 1} decode steps, logits of "
        f"the prefill and of every step and the greedy tokens bit-equal to "
        f"phase 5's; launches {counts}; prefill wall {p_wall * 1e3:.3f} ms "
        f"sharded vs {lm_ref['prefill_wall'] * 1e3:.3f} ms in phase 5, decode "
        f"step wall {d_wall * 1e3:.3f} ms vs {lm_ref['decode_wall'] * 1e3:.3f} "
        f"ms (mean of {LM_NEW - 1}, {card})")
    del model, cache, logits
    torch.cuda.empty_cache()
    return moved


def serve_sharded(torch, np, dev, card) -> dict:
    """Phase 12a: TinyBio served on the sharded lanes of ``SHARDED_LANES``
    (see the module docstring); -> launches of each TinyBio kernel in the
    counted runs."""
    from repro_torch.apps import tinybio
    from repro_torch.core import EGPU_16T
    from repro_torch.distributed.sharding import LocalMesh
    from repro_torch.kernels import common
    from repro_torch.serve import QueueWorker, Server, ShardedWorker, data_mesh
    n = tinybio.TINYBIO_WORKLOAD["n"]
    stages = {d: tinybio.tinybio_stages(EGPU_16T, 0, d)[0]
              for d in ("cuda", "cpu")}
    signals = [tinybio.synth_signal(n, s) for s in range(SHARDED_REQUESTS)]

    def mesh_of(device, positions):
        if device == "cuda":
            return (data_mesh(1) if positions == 1 else
                    LocalMesh([torch.device(dev)] * positions, ("data",)))
        return data_mesh(positions, device="cpu")

    def serve(worker, device, max_batch, clock=None):
        kw = {} if clock is None else {"clock": clock}
        srv = Server(stages[device], workers=(worker,), bucket_sizes=(n,),
                     max_batch=max_batch, device=device, **kw)
        check(srv.warmup(signals[0]) == 1, "sharded lane: warmup captured "
              "other than one graph")
        return srv

    def run(srv, clock=None):
        rids = []
        for i, sig in enumerate(signals):
            if clock is not None:
                clock.t = 1e-4 * i
            rids.append(srv.submit(sig))
        if clock is not None:
            clock.t = 1e-4 * len(signals) + 1e-3
        srv.flush()
        return [srv.result(r) for r in rids]

    def same_bits(a, b):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.view(torch.int32), b.view(torch.int32)))

    total = {name: 0 for name in TINYBIO_KERNELS}
    for label, positions, max_batch, shards in SHARDED_LANES:
        t_lane = time.perf_counter()
        plain = run(serve(QueueWorker(EGPU_16T, device="cuda"), "cuda",
                          max_batch))
        lane = ShardedWorker(EGPU_16T, mesh_of("cuda", positions),
                             name=f"mesh{positions}")
        srv = serve(lane, "cuda", max_batch)
        run(srv)        # warm: the lane's plan, its streams' first blocks
        torch.cuda.synchronize()
        common.reset_launches()
        t0 = time.perf_counter()
        outs = run(srv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = dict(common.LAUNCHES)
        batches = -(-len(signals) // max_batch)
        for name in KERNELS:
            want = batches * shards if name in TINYBIO_KERNELS else 0
            check(moved[name] == want,
                  f"12a {label}: {name} launched {moved[name]} times in "
                  f"{batches} micro-batches, expected {want} (once a shard)")
            if name in TINYBIO_KERNELS:
                total[name] += moved[name]
        for i, (a, b) in enumerate(zip(outs, plain)):
            check(len(a) == len(b) == 1 and a[0].is_cuda
                  and same_bits(a[0], b[0]),
                  f"12a {label}: request {i} differs from the plain lane")
        (graph,) = srv.cache._graphs.values()
        check(lane._plan(graph).shards == shards,
              f"12a {label}: the lane split a micro-batch "
              f"{lane._plan(graph).shards} ways, expected {shards}")
        # the modeled report on a virtual clock: the card's == the CPU's
        reports, caches = [], []
        for device in ("cuda", "cpu"):
            vc = VClock()
            srv_vc = serve(ShardedWorker(EGPU_16T, mesh_of(device, positions),
                                         name=f"mesh{positions}"),
                           device, max_batch, vc)
            outs_vc = run(srv_vc, vc)
            reports.append(modeled_report(srv_vc.report()))
            caches.append(srv_vc.cache.stats())
            if device == "cuda":
                check(all(same_bits(a[0], b[0]) for a, b in zip(outs_vc, outs)),
                      f"12a {label}: the virtual-clock run's bits differ")
        check(reports[0] == reports[1],
              f"12a {label}: a modeled ServeReport field differs between "
              "card and CPU")
        check(caches[0] == caches[1],
              f"12a {label}: cache stats card {caches[0]} != CPU {caches[1]}")
        (qs,) = srv.report().queues
        # one micro-batch at a time, the counters reset just before each:
        # each TinyBio kernel launched once a shard, nothing else
        for _ in range(2):
            torch.cuda.synchronize()
            common.reset_launches()
            for sig in signals[:max_batch]:
                srv.submit(sig)
            srv.flush()
            torch.cuda.synchronize()
            one = dict(common.LAUNCHES)
            for name in KERNELS:
                want = shards if name in TINYBIO_KERNELS else 0
                check(one[name] == want,
                      f"12a {label}: one micro-batch launched {name} "
                      f"{one[name]} times, expected {want} (once a shard)")
        log(f"phase 12a {label}: {len(signals)} requests in {batches} "
            f"micro-batches of {max_batch}, {shards} launch(es) a micro-batch "
            f"(mesh {qs.mesh_axes}, utilization {qs.mesh_utilization}, lane "
            f"width {qs.shards}); launches {moved}, and "
            f"{ {k: one[k] for k in TINYBIO_KERNELS} } a micro-batch alone; "
            f"bit-equal to the plain lane; modeled report and cache "
            f"{caches[0]} == the CPU's; wall {wall * 1e3:.3f} ms, "
            f"{wall / len(signals) * 1e3:.3f} ms a request ({card})")
        # the same requests again, profiled, for the idle share.  A trace
        # may lose device events (whole windows came back empty late in a
        # run, and others short by a third): it may hold fewer of our
        # kernels than ran, never more; a short trace in every window is
        # logged and its idle share not read
        want = batches * shards
        prof = profile_ours(torch, lambda: run(srv),
                            tuple(TINYBIO_DEVICE_NAMES.values()),
                            len(TINYBIO_DEVICE_NAMES) * want, f"12a {label}")
        held = {dev_name: sum(c for k, c in prof[3].items() if dev_name in k)
                for dev_name in TINYBIO_DEVICE_NAMES.values()}
        check(all(n_ <= want for n_ in held.values()),
              f"12a {label}: the profiled run's trace holds {held}, more than "
              f"the {want} launches of each that ran")
        what = (f"the {len(signals)} requests again, profiled ({batches} "
                f"micro-batches of {max_batch}, {shards} launch(es) each)")
        if all(n_ == want for n_ in held.values()):
            log(f"phase 12a {label}: " + profile_line(what, *prof[:3]))
        else:
            log(f"phase 12a {label}: {what}: the trace held {held} of {want} "
                f"launches each in every window; idle share not measured")
        log(f"phase 12a {label}: {time.perf_counter() - t_lane:.1f} s of wall")
    return total


def collective_layer(torch, np, dev, card) -> None:
    """Phase 12b: the int8 compressed all-reduce and elastic restore on
    NCCL in a world of one rank (see the module docstring)."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.checkpoint import restore_sharded, save_checkpoint
    from repro_torch.configs import example_config, get as get_arch
    from repro_torch.distributed import compression
    from repro_torch.distributed.elastic import gather_tree
    from repro_torch.distributed.sharding import (TRAIN_FSDP_RULES,
                                                  distribute_tree,
                                                  param_shardings)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import init_params, leaves_with_path, map_tree
    from repro_torch.models.transformer import model_spec

    def bits(t):
        t = t.detach()
        if t.dtype in (torch.float32, torch.bfloat16, torch.int32, torch.int8):
            t = t.reshape(-1).view(torch.uint8)
        return t

    mesh = make_host_mesh()
    try:
        check(dist.get_backend() == "nccl" and mesh.device_type == "cuda",
              f"12b: host mesh on {dist.get_backend()} / {mesh.device_type}")
        cfg = get_arch(PSUM_ARCH)
        shape = (cfg.vocab, cfg.d_model)
        gen = torch.Generator(device=dev).manual_seed(12)
        g = torch.randn(shape, generator=gen, device=dev)
        e = torch.randn(shape, generator=gen, device=dev) * 1e-3
        seen = []
        orig = dist.all_gather_into_tensor

        def wrapped(output, input, *a, **kw):
            seen.append((input.dtype, input.numel()))
            return orig(output, input, *a, **kw)

        dist.all_gather_into_tensor = wrapped
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, new_e = compression.compressed_psum(g, e, "data", mesh)
            torch.cuda.synchronize()
            psum_s = time.perf_counter() - t0
        finally:
            dist.all_gather_into_tensor = orig
        check(seen == [(torch.int8, g.numel()), (torch.float32, 1)],
              f"12b: the gathered payloads were {seen}, expected int8 then "
              "one f32 scale")
        g_cpu, e_cpu = g.cpu(), e.cpu()
        del g, e
        q, scale, e_ref = compression.compress_int8(g_cpu, e_cpu)
        mean_ref = torch.sum(q.to(torch.float32).view((1,) + shape)
                             * scale.reshape(1, 1, 1), dim=0) / 1
        check(torch.equal(bits(mean.cpu()), bits(mean_ref)),
              "12b: compressed_psum's mean differs from the CPU codec's bits")
        check(torch.equal(bits(new_e.cpu()), bits(e_ref)),
              "12b: compressed_psum's new error differs from the CPU codec's")
        del mean, new_e, g_cpu, e_cpu, q, e_ref, mean_ref
        log(f"phase 12b: compressed_psum of {PSUM_ARCH}'s embedding gradient "
            f"{shape} f32 ({shape[0] * shape[1] * 4 / 1e6:.0f} MB) on NCCL, "
            f"world 1: {psum_s * 1e3:.3f} ms (first call), mean and error "
            f"bit-equal to the CPU codec, payload int8 ({card})")
        # elastic restore of the example model's tree onto the mesh
        ecfg = example_config()
        spec = model_spec(ecfg)
        tree = init_params(spec, seed=0, device=dev)
        placements = param_shardings(spec, TRAIN_FSDP_RULES, mesh)
        placed = distribute_tree(tree, placements, mesh)
        whole = gather_tree(placed)
        n_params = sum(t.numel() for _, t in leaves_with_path(tree))
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "step_00000001")
            t0 = time.perf_counter()
            save_checkpoint(path, whole, step=1)
            save_s = time.perf_counter() - t0
            like = map_tree(lambda _t: None, tree)
            t0 = time.perf_counter()
            back, manifest = restore_sharded(path, like, spec,
                                             TRAIN_FSDP_RULES, mesh)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        check(manifest["step"] == 1, "12b: the restored manifest's step")
        saved = dict(leaves_with_path(tree))
        for p_, dt in leaves_with_path(back):
            check(dt.device_mesh is mesh or dt.device_mesh == mesh,
                  f"12b: {p_} restored on another mesh")
            check(tuple(dt.placements) == tuple(dict(leaves_with_path(
                placements))[p_]), f"12b: {p_} restored under other placements")
            check(dt.to_local().is_cuda and torch.equal(
                bits(dt.full_tensor()), bits(saved[p_])),
                f"12b: {p_} changed bits through save + restore_sharded")
        log(f"phase 12b: the example model's tree ({n_params / 1e6:.1f} M f32 "
            f"parameters, {len(saved)} leaves) distributed under "
            f"{TRAIN_FSDP_RULES.name}, saved in {save_s:.2f} s, restored onto "
            f"the mesh with restore_sharded in {restore_s:.2f} s, every leaf's "
            "bits kept")
    finally:
        dist.destroy_process_group()


def main() -> int:
    # Keep CUPTI initialised between profiler sessions (PyTorch's own
    # setting for traces beside CUDA graphs, which this script replays):
    # with the default teardown and re-initialisation after every session,
    # traces on the card came back with no device event, or without a
    # session's first kernel, in some sessions of a run.
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    try:
        from benchmarks_torch import (bench_dispatch, bench_gemm_overhead,
                                      bench_multiqueue, bench_overload,
                                      bench_power, bench_static,
                                      bench_transfer, ptxas_report)
        from repro_torch.configs import example_config, get as get_arch
        from repro_torch.apps import tinybio
        from repro_torch.core import (APU, EGPU_4T, EGPU_8T, EGPU_16T,
                                      CommandQueue, Context, Device, Program,
                                      Stage, optimal_ndrange)
        from repro_torch.kernels import common
        from repro_torch.kernels.gemm.gemm import plan_split_k, tiles_from_knobs
        from repro_torch.kernels.gemm.ops import gemm
        from repro_torch.kernels.gemm.ref import gemm_plain
        from repro_torch.kernels.delineate.ops import delineate
        from repro_torch.kernels.delineate.ref import delineate_ref
        from repro_torch.kernels.fir.fir import MAX_THREADS as FIR_MAX_THREADS
        from repro_torch.kernels.fir.fir import ROWS as FIR_ROWS
        from repro_torch.kernels.fir.fir import FirPlan, launch_fir, plan_fir
        from repro_torch.kernels.fir.ops import fir
        from repro_torch.kernels.fir.ref import fir_ref
        from repro_torch.kernels.stockham_fft.ops import fft, power_spectrum
        from repro_torch.kernels.stockham_fft.ref import stockham_fft_ref
        from repro_torch.kernels.svm.ops import svm_decision
        from repro_torch.kernels.svm.svm import plan_svm
        from repro_torch.kernels.svm.ref import svm_decision_ref
        from repro_torch.kernels.flash_attention.ops import flash_attention
        from repro_torch.kernels.flash_attention import (
            flash_attention as fa_module)
        from repro_torch.kernels.decode_attention import (
            decode_attention as da_module)
        from repro_torch.kernels.decode_attention.decode_attention import (
            plan_decode_splits)
        from repro_torch.kernels.flash_attention.ref import (
            flash_attention_bwd_plain, flash_attention_plain)
        from repro_torch.kernels.flash_attention.ops import (
            _card_forward, flash_attention_bwd)
        from repro_torch.kernels.decode_attention.ops import (combine_partials,
                                                              decode_attention)
        from repro_torch.kernels.decode_attention.ref import (
            decode_attention_masked_ref, decode_attention_partial_ref,
            decode_attention_ref)
        from repro_torch.kernels.norm.ops import group_norm, layer_norm, rms_norm
        from repro_torch.kernels.norm.ref import (group_norm_ref,
                                                  layer_norm_ref, rms_norm_ref)
        from repro_torch.kernels.mamba_scan.mamba_scan import (
            bwd_scratch_words as mamba_scratch_words, plan_mamba, rows_16b)
        from repro_torch.kernels.mamba_scan.ops import (mamba_scan,
                                                        mamba_scan_bwd,
                                                        selective_scan)
        from repro_torch.kernels.mamba_scan.ref import (mamba_scan_bwd_plain,
                                                        mamba_scan_plain)
        from repro_torch.kernels.rwkv6_scan.ops import (rwkv6_scan,
                                                        rwkv6_scan_bwd)
        from repro_torch.kernels.rwkv6_scan.rwkv6_scan import bwd_scratch_words
        from repro_torch.kernels.rwkv6_scan.ref import (rwkv6_scan_bwd_plain,
                                                        rwkv6_scan_plain,
                                                        rwkv6_scan_seq_grad)
        from repro_torch.models.params import init_params, leaves_with_path
        from repro_torch.models.transformer import Transformer, model_spec
        from repro_torch.train.serve import (greedy_generate, make_decode_step,
                                             make_prefill_step)
    except ImportError as e:
        print(f"chip_smoke: cannot import the port from {ROOT / 'src'}: {e}",
              file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    # Full fp32 everywhere: the plain SVM's and GeMM's matmul and the conv1d
    # yardstick would otherwise be allowed TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. card and build --------------------------------------------------
    phase_done("1")
    card = nvidia_smi("name,power.limit")
    log(card)
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    peak_int32_macs = INT32_MAC_PER_CLK_PER_SM * n_sms * max_sm_mhz * 1e6
    log(f"int32 multiply-add peak: {INT32_MAC_PER_CLK_PER_SM} per clock per "
        f"SM x {n_sms} SMs x {max_sm_mhz:.0f} MHz (max SM clock) = "
        f"{peak_int32_macs / 1e12:.3f} T MAC/s")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    info = common.build_kernels()
    common.kernel_library()
    log(f"phase 1: kernels {'built' if info['built'] else 'found'} at "
        f"{info['path'].relative_to(ROOT)} in {info['seconds']:.1f} s")
    # registers and spills of the kernels PTXAS_SOURCES names (ptxas -v), in
    # a thread whose nvcc processes compile beside phase 2; logged in phase 3
    from concurrent.futures import ThreadPoolExecutor
    ptxas_pool = ThreadPoolExecutor(1)
    ptxas_job = ptxas_pool.submit(ptxas_report.report, PTXAS_SOURCES)

    # -- 2. each kernel against its plain version, on the card --------------
    phase_done("2")
    def launched(name, fn):
        before = common.LAUNCHES[name]
        out = fn()
        torch.cuda.synchronize()
        check(common.LAUNCHES[name] == before + 1,
              f"{name}: the launch counter did not move by one")
        return out

    def err(a, b):
        return float((a.double() - b.double()).abs().max().item()) if a.numel() else 0.0

    stages, inputs = tinybio.tinybio_stages(EGPU_16T, 0, dev)
    x, h = inputs[0], stages[0].consts[0]
    sv_main, alpha_main = stages[3].consts[0], stages[3].consts[1]
    rng = np.random.default_rng(0)
    max_err = {}

    # fir: the same sums in the same order and roundings as the plain
    # version (float: separate __fmul_rn / __fadd_rn; integer: uint32
    # wraparound, then >> 15), so every output must equal it bit for bit
    def same_bits(a, b_):
        return a.dtype == b_.dtype and a.shape == b_.shape and torch.equal(
            a.view(torch.int32) if a.dtype == torch.float32 else a,
            b_.view(torch.int32) if b_.dtype == torch.float32 else b_)

    def int_tensor(lo, hi, size, dtype):
        return torch.from_numpy(rng.integers(lo, hi, size).astype(dtype)).to(dev)

    y = launched("fir", lambda: fir(x, h))
    max_err["fir"] = err(y, fir_ref(x, h))
    check(same_bits(y, fir_ref(x, h)), f"fir f32 not bit-equal (max err {max_err['fir']})")
    xr = torch.from_numpy(rng.standard_normal(1000).astype(np.float32)).to(dev)
    hr = torch.from_numpy(rng.standard_normal(33).astype(np.float32) / 33).to(dev)
    check(same_bits(launched("fir", lambda: fir(xr, hr)), fir_ref(xr, hr)),
          "fir f32 ragged")
    xi = int_tensor(-2 ** 15, 2 ** 15, 65_536, np.int16)
    hi = int_tensor(-2 ** 15, 2 ** 15, 128, np.int16)
    check(torch.equal(launched("fir", lambda: fir(xi, hi)), fir_ref(xi, hi)),
          "fir Q15 int16 not exact")
    check(torch.equal(launched("fir", lambda: fir(xi[:1001], hi[:17])),
                      fir_ref(xi[:1001], hi[:17])), "fir Q15 ragged not exact")
    # int32 products of ~2^30 x 2^30 that wrap; int32 taps with an int16
    # signal; views off 16-byte alignment (the element-by-element loads);
    # taps from 1 to 5000 (5000: ten chunks of the kernel's shared memory)
    xw_ = int_tensor(2 ** 29, 2 ** 31 - 1, 3001, np.int32)
    hw_ = int_tensor(2 ** 29, 2 ** 31 - 1, 40, np.int32)
    fir_cases = {"int32 wraparound": (xw_, hw_),
                 "int16 signal, int32 taps": (xi[:5003], hi[:77].to(torch.int32)),
                 "f32 view at +4 bytes": (x[1:20_001], h),
                 "int16 view at +2 bytes": (xi[1:9_001], hi)}
    for taps_ in (1, 3, 17, 33, 127, 128, 129, 4096, 5000):
        fir_cases[f"f32 taps {taps_}"] = (
            xr[:997] if taps_ < 100 else x[:10_007],
            torch.from_numpy(rng.standard_normal(taps_).astype(np.float32) / taps_).to(dev))
        fir_cases[f"Q15 taps {taps_}"] = (xi[:10_007], int_tensor(-2 ** 15, 2 ** 15, taps_, np.int16))
    for what, (xc_, hc_) in fir_cases.items():
        check(same_bits(launched("fir", lambda: fir(xc_, hc_)), fir_ref(xc_, hc_)),
              f"fir {what} not bit-equal to the plain version")
    # every outputs-a-thread count and block sizes from 1 to 256 threads
    # (the most the kernel takes) give the same bits (the plan changes none)
    fir_plans = 0
    for xc_, hc_ in ((x, h), (xi[:1001], hi[:17]), fir_cases["f32 taps 5000"]):
        want_ = fir_ref(xc_, hc_)
        for rows_ in FIR_ROWS:
            for threads_ in (1, 125, FIR_MAX_THREADS):
                plan_ = FirPlan(rows_, threads_)
                out_ = torch.empty_like(xc_)
                launched("fir", lambda: launch_fir(xc_, hc_, out_, plan_))
                check(same_bits(out_, want_),
                      f"fir with plan {plan_} not bit-equal to the plain version")
                fir_plans += 1
    log(f"phase 2: fir ok (bit-equal to the plain version: TinyBio f32 and Q15, "
        f"{len(fir_cases)} more cases with taps 1 .. 5000, int32 wraparound and "
        f"unaligned views, and {fir_plans} forced plans; TinyBio's plan "
        f"{tuple(plan_fir(x.numel(), h.numel(), n_sms))})")

    # delineate: exact, on the FIR output and on ragged, short and unaligned
    # signals of each dtype, with the thresholds cast to x's dtype
    flags = launched("delineate", lambda: delineate(y, 0))
    check(torch.equal(flags, delineate_ref(y, 0)), "delineate not exact")
    max_err["delineate"] = 0.0
    xd = (xi[:1001] // 512).contiguous()
    xs32 = (xw_ // (2 ** 26)).contiguous()
    dl_cases = {"int16 ragged": (xd, 3), "f32 ragged": (xr, 0.25),
                "int32": (xs32, 3), "int16 thr 2.7": (xd, 2.7),
                "f32 view at +4 bytes": (y[1:60_001], 0),
                "int16 view at +2 bytes": (xd[1:], 3)}
    for n_ in (1, 2, 3, 7, 9, 33):
        dl_cases[f"f32 n={n_}"] = (xr[:n_], 0.25)
        dl_cases[f"int16 n={n_}"] = (xd[:n_], 3)
    for what, (xc_, thr_) in dl_cases.items():
        check(torch.equal(launched("delineate", lambda: delineate(xc_, thr_)),
                          delineate_ref(xc_, thr_)), f"delineate {what} not exact")
    log(f"phase 2: delineate ok (exact, {int((flags != 0).sum())} extrema; "
        f"{len(dl_cases)} more cases)")

    # fft on TinyBio's 128 windows of 512: the same butterflies and twiddle
    # angles as the plain version, cosf/sinf from the same CUDA math library;
    # tolerance 1e-6 of the largest |X|
    w = y[: 128 * 512].reshape(128, 512)
    re, im = launched("stockham_fft", lambda: fft(w))
    pre, pim = stockham_fft_ref(w, torch.zeros_like(w))
    scale = float(torch.sqrt(pre * pre + pim * pim).max())
    max_err["stockham_fft"] = max(err(re, pre), err(im, pim))
    check(max_err["stockham_fft"] <= 1e-6 * scale,
          f"fft error {max_err['stockham_fft']} vs scale {scale}")
    wr = torch.from_numpy(rng.standard_normal((3, 2048)).astype(np.float32)).to(dev)
    wi = torch.from_numpy(rng.standard_normal((3, 2048)).astype(np.float32)).to(dev)
    gre, gim = launched("stockham_fft", lambda: fft(wr, wi))
    rre, rim = stockham_fft_ref(wr, wi)
    ref_np = np.fft.fft(wr.cpu().numpy() + 1j * wi.cpu().numpy())
    check(max(err(gre, rre), err(gim, rim)) <= 1e-6 * float(np.abs(ref_np).max()),
          "fft (3, 2048) vs plain")
    check(np.allclose(gre.cpu().numpy() + 1j * gim.cpu().numpy(), ref_np,
                      rtol=1e-4, atol=1e-4 * 2048), "fft (3, 2048) vs numpy")
    # every n the kernel takes, 1 .. 8192 (batch 3, complex input), on the
    # 16-byte copy path and, at n = 512, on the 4-byte one (a base 4 bytes
    # off 16-byte alignment): the same tolerance
    fft_err = {}
    for s_ in range(14):
        n_ = 1 << s_
        for offset in (0, 1) if n_ == 512 else (0,):
            flat = torch.from_numpy(rng.standard_normal(2 * 3 * n_ + offset).astype(
                np.float32)).to(dev)
            pr_, pi_ = (flat[offset + i * 3 * n_:offset + (i + 1) * 3 * n_].view(3, n_)
                        for i in range(2))
            gre, gim = launched("stockham_fft", lambda: fft(pr_, pi_))
            rre, rim = stockham_fft_ref(pr_, pi_)
            mag = float(torch.sqrt(rre * rre + rim * rim).max())
            fft_err[n_, offset] = max(err(gre, rre), err(gim, rim)) / mag
            check(fft_err[n_, offset] <= 1e-6,
                  f"fft n={n_} (offset {offset}) error {fft_err[n_, offset]} of max |X|")
    # power_spectrum is the same launch with |X|^2 in its last pass: the bits
    # of re*re + im*im over the card's own fft, for TinyBio's windows, one
    # 1-D signal and n = 8192
    for sig in (w, w[5], flat[:3 * 8192].view(3, 8192)):
        ps = launched("stockham_fft", lambda: power_spectrum(sig))
        fre, fim = fft(sig)
        check(torch.equal(ps.view(torch.int32), (fre * fre + fim * fim).view(torch.int32)),
              f"power_spectrum {tuple(sig.shape)} differs from re*re + im*im of fft")
    log(f"phase 2: stockham_fft ok (max abs err {max_err['stockham_fft']:.3g}, "
        f"max |X| {scale:.4g}; n = 1 .. 8192, error / max |X| at most "
        f"{max(fft_err.values()):.3g}; power_spectrum bit-equal to re*re + im*im "
        f"of fft)")

    # svm at q=128, m=256, d=36, with support vectors drawn near the queries
    # so the RBF values are not all 0; fp32 dots and sums in another order
    # than the plain version's matmul: rtol 1e-4, atol 1e-5
    feats = tinybio._feature_kernel(512, 128)(y, flags)
    idx = torch.from_numpy(rng.integers(0, 128, 256)).to(dev)
    sv_near = (feats[idx] + 0.1 * torch.from_numpy(
        rng.standard_normal((256, 36)).astype(np.float32)).to(dev)).contiguous()
    b = torch.tensor(0.1, device=dev)
    got = launched("svm", lambda: svm_decision(feats, sv_near, alpha_main, b, 0.5))
    want = svm_decision_ref(feats, sv_near, alpha_main, b, 0.5)
    check(float((want - b).abs().max()) > 1e-3, "svm check has no RBF signal")
    max_err["svm"] = err(got, want)
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-5),
          f"svm rbf error {max_err['svm']}")
    check(torch.allclose(launched("svm", lambda: svm_decision(feats, sv_near, alpha_main, b)),
                         svm_decision_ref(feats, sv_near, alpha_main, b),
                         rtol=1e-4, atol=1e-5), "svm linear")
    xq = torch.from_numpy(rng.uniform(-1, 1, (13, 7)).astype(np.float32)).to(dev)
    svq = torch.from_numpy(rng.uniform(-1, 1, (300, 7)).astype(np.float32)).to(dev)
    aq = torch.from_numpy(rng.standard_normal(300).astype(np.float32) / 300).to(dev)
    check(torch.allclose(launched("svm", lambda: svm_decision(xq, svq, aq, 0.0, 0.5)),
                         svm_decision_ref(xq, svq, aq, 0.0, 0.5),
                         rtol=1e-4, atol=1e-5), "svm ragged")
    # the bias inside the kernel: svm(b) has the bits of svm(0) + b, with b a
    # 0-d tensor on the card, a float and a 0-d CPU tensor
    s0 = launched("svm", lambda: svm_decision(feats, sv_near, alpha_main, 0.0, 0.5))
    for what, bb in (("card tensor", b), ("float", 0.1),
                     ("CPU tensor", torch.tensor(0.1))):
        got_b = launched("svm", lambda: svm_decision(feats, sv_near, alpha_main, bb, 0.5))
        check(torch.equal(got_b.view(torch.int32), (s0 + bb).view(torch.int32)),
              f"svm with the bias as a {what} differs from svm(0) + b")
    # other shapes: d = 1024, q that give 4 and 8 queries a block (1024,
    # 1100; plan_svm), a ragged d = 7 on the 4-byte load path; the same
    # tolerance
    svm_plans = {}
    for q_, m_, d_ in ((64, 512, 1024), (1024, 1024, 36), (1100, 1024, 36),
                       (13, 300, 7)):
        xq = torch.from_numpy(rng.uniform(-1, 1, (q_, d_)).astype(np.float32)).to(dev)
        spread = 0.2 if d_ < 100 else 0.01
        svq = (xq[torch.from_numpy(rng.integers(0, q_, m_)).to(dev)] + spread
               * torch.from_numpy(rng.standard_normal((m_, d_)).astype(np.float32)).to(dev))
        aq = torch.from_numpy(rng.standard_normal(m_).astype(np.float32) / m_).to(dev)
        want = svm_decision_ref(xq, svq, aq, b, 0.5)
        check(float((want - b).abs().max()) > 1e-3, f"svm {q_, m_, d_} has no RBF signal")
        check(torch.allclose(launched("svm", lambda: svm_decision(xq, svq, aq, b, 0.5)),
                             want, rtol=1e-4, atol=1e-5), f"svm at {q_, m_, d_}")
        svm_plans[q_, m_, d_] = plan_svm(q_, n_sms)
    check({p_.queries for p_ in svm_plans.values()} >= {1, 4, 8},
          f"svm: phase 2 missed a queries-per-block count: {svm_plans}")
    log(f"phase 2: svm ok (max abs err {max_err['svm']:.3g}; svm(b) bit-equal to "
        f"svm(0) + b for b on the card, a float and a CPU tensor; plans "
        + ", ".join(f"{k_}: {p_.queries} queries a block" for k_, p_ in svm_plans.items())
        + ")")

    # gemm, each case through the tilings of all three configs, which must
    # give identical bits (compared as int32 words, so -0.0 != +0.0).
    # int32: exact against the plain version (uint32 wraparound on both
    # sides).  f32: one in-order fused multiply-add chain per output against
    # the plain version's matmul (TF32 off): rtol = atol = 2e-4, as
    # tests/test_kernels.py states for the JAX kernel at these shapes.
    configs = (EGPU_4T, EGPU_8T, EGPU_16T)
    knobs = {cfg.name: cfg.cuda_knobs() for cfg in configs}

    def gemm_case(a, b, what):
        outs = [launched("gemm", lambda k=k: gemm(a, b, k)) for k in knobs.values()]
        bits = [o.view(torch.int32) for o in outs]
        check(all(torch.equal(x, bits[0]) for x in bits),
              f"gemm {what}: the config tilings' outputs differ")
        want = gemm_plain(a, b)
        if a.dtype == torch.int32:
            check(torch.equal(outs[0], want), f"gemm {what}: not exact")
        else:
            check(torch.allclose(outs[0], want, rtol=2e-4, atol=2e-4),
                  f"gemm {what}: error {err(outs[0], want)}")
        return err(outs[0], want)

    def ints(lo, hi, *shape):
        return torch.from_numpy(
            rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)).to(dev)

    def floats(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    # the int32 cases where the tiling leaves the card idle split K across
    # blocks (atomic uint32 sums, exact in any order); each case logs the
    # plan of every tiling, and some must split
    split_plans = {}

    def log_splits(what, m, k, n):
        split_plans[what] = [tuple(plan_split_k(m, n, k, tiles_from_knobs(kn),
                                                n_sms, torch.int32))
                             for kn in knobs.values()]

    gemm_err = {}
    for size in (32, 64, 128, 256):
        log_splits(f"int32 {size}", size, size, size)
        gemm_err[f"int32 {size}"] = gemm_case(
            ints(-64, 64, size, size), ints(-64, 64, size, size), f"int32 {size}")
    log_splits("int32 257x129x65", 257, 129, 65)
    log_splits("int32 wraparound 96x200x80", 96, 200, 80)
    gemm_err["int32 257x129x65"] = gemm_case(
        ints(-64, 64, 257, 129), ints(-64, 64, 129, 65), "int32 ragged")
    aw, bw_ = ints(2 ** 20 - 64, 2 ** 20 + 64, 96, 200), ints(-2 ** 20 - 64, -2 ** 20 + 64, 200, 80)
    exact = aw.cpu().numpy().astype(np.int64) @ bw_.cpu().numpy().astype(np.int64)
    check(bool((np.abs(exact) >= 2 ** 31).all()), "gemm wraparound case does not wrap")
    gemm_err["int32 wraparound"] = gemm_case(aw, bw_, "int32 wraparound")
    check(np.array_equal(gemm(aw, bw_).cpu().numpy(),
                         ((exact + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)),
          "gemm wraparound differs from the int64 product modulo 2^32")
    for m, k, n in ((8, 8, 8), (100, 70, 50), (128, 128, 128), (257, 129, 65),
                    (512, 256, 384)):
        gemm_err[f"f32 {m}x{k}x{n}"] = gemm_case(floats(m, k), floats(k, n),
                                                 f"f32 {m}x{k}x{n}")
    max_err["gemm"] = max(v for key, v in gemm_err.items() if key.startswith("int32"))
    check(any(p[0] > 1 for plans in split_plans.values() for p in plans),
          f"gemm: no int32 case split K: {split_plans}")
    log("phase 2: gemm ok (int32 exact incl. ragged and wraparound; 4T/8T/16T "
        "tilings bit-identical; int32 (splits, k-tiles a split) for 4T/8T/16T: "
        + ", ".join(f"{k} {v}" for k, v in split_plans.items())
        + "; max abs err vs plain: "
        + ", ".join(f"{k} {v:.3g}" for k, v in gemm_err.items()) + ")")

    # flash_attention against its plain version (the JAX package's blocked
    # online softmax, what JAX runs off a TPU), at the LM path's geometry.
    # Both compute in f32 and sum in another order: float32 within 1e-5 of
    # max |out|; bfloat16 outputs, which both round from f32, within one
    # bf16 ulp of each value plus the same 1e-5 of max |out|.  v is a
    # strided (B, T, KVH, D) -> (B, KVH, T, D) view, as the model passes it.
    def qkv(b, h, kvh, s, t, dk, dv, dtype):
        def arr(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
        return (arr(b, h, s, dk), arr(b, kvh, t, dk),
                arr(b, t, kvh, dv).transpose(1, 2))

    def held_to_plain(what, got, q, k, v, **kw):
        want = flash_attention_plain(q, k, v, **kw)
        check(got.shape == want.shape and got.dtype == q.dtype,
              f"flash_attention {what}: shape or dtype")
        g, w = got.float(), want.float()
        tol = 1e-5 * float(w.abs().max())
        if q.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * torch.maximum(g.abs(), w.abs())
        check(bool(((g - w).abs() <= tol).all()) and bool(torch.isfinite(g).all()),
              f"flash_attention {what}: error {err(got, want)}")
        return err(got, want)

    def flash_case(what, dims, dtype, **kw):
        q, k, v = qkv(*dims, dtype)
        got = launched("flash_attention", lambda: flash_attention(q, k, v, **kw))
        return held_to_plain(what, got, q, k, v, **kw)

    bf16 = torch.bfloat16
    lm_cfg = get_arch(LM_ARCH)
    lm_h, lm_kvh, lm_d = lm_cfg.n_heads, lm_cfg.n_kv_heads, lm_cfg.head_dim
    # phase 9's prefills: moonshot's (H = KVH, a GQA group of one, on the
    # tensor cores) and deepseek's MLA
    moe_dims, _ = engine_flash_dims(get_arch(MOE_ARCHS[0][0]))
    mla_dims, mla_scale = engine_flash_dims(get_arch(MOE_ARCHS[1][0]))
    # deepseek's training shape (phase 11e): the launcher's batch of 8 x
    # 128 tokens, each of its 128 heads attending to its own keys
    mla_train_dims = (TRAIN_BATCH, mla_dims[1], mla_dims[2], TRAIN_SEQ,
                      TRAIN_SEQ, mla_dims[5], mla_dims[6])
    pali_cfg = get_arch(PALI_ARCH)
    pali_h, pali_kvh, pali_d = (pali_cfg.n_heads, pali_cfg.n_kv_heads,
                                pali_cfg.head_dim)
    pali_s = pali_cfg.n_prefix_embed + PALI_TEXT
    pali_dims = (PALI_BATCH, pali_h, pali_kvh, pali_s, pali_s, pali_d, pali_d)
    # paligemma's training shape (phase 11g): the launcher's 8 x 128 tokens
    # behind the 256 patch rows
    pali_train_s = pali_cfg.n_prefix_embed + TRAIN_SEQ
    pali_train_dims = (TRAIN_BATCH, pali_h, pali_kvh, pali_train_s,
                       pali_train_s, pali_d, pali_d)
    # hubert's training shape (phase 11f: the launcher's 8 x 128 frames)
    # and its encode shape (phase 11c)
    hu_cfg = get_arch(ENCODE_ARCH)
    hu_h, hu_kvh, hu_d = hu_cfg.n_heads, hu_cfg.n_kv_heads, hu_cfg.head_dim
    hu_train_dims = (TRAIN_BATCH, hu_h, hu_kvh, TRAIN_SEQ, TRAIN_SEQ, hu_d, hu_d)
    hu_encode_dims = (ENCODE_BATCH, hu_h, hu_kvh, ENCODE_FRAMES, ENCODE_FRAMES,
                      hu_d, hu_d)
    fa_err = {
        "prefill B=4 S=T=256 bf16": flash_case(
            "prefill", (LM_BATCH, lm_h, lm_kvh, LM_PROMPT, LM_PROMPT, lm_d, lm_d), bf16),
        # the decode engine's prefill (phase 8): one prompt at a time
        "engine prefill B=1 S=T=256 bf16": flash_case(
            "engine prefill", (1, lm_h, lm_kvh, ENGINE_PROMPT, ENGINE_PROMPT,
                               lm_d, lm_d), bf16),
        "ragged S=T=300 bf16": flash_case(
            "ragged", (2, lm_h, lm_kvh, 300, 300, lm_d, lm_d), bf16),
        "suffix S=64 T=512 q_offset=448 bf16": flash_case(
            "suffix", (2, lm_h, lm_kvh, 64, 512, lm_d, lm_d), bf16, q_offset=448),
        "non-causal S=256 T=512 bf16": flash_case(
            "non-causal", (2, lm_h, lm_kvh, 256, 512, lm_d, lm_d), bf16, causal=False),
        "prefill geometry f32": flash_case(
            "f32", (2, lm_h, lm_kvh, LM_PROMPT, LM_PROMPT, lm_d, lm_d), torch.float32),
        "Dk=96 Dv=64 f32": flash_case(
            "Dk=96 Dv=64", (2, 8, 4, 200, 200, 96, 64), torch.float32),
        "Dk=Dv=32 S=T=77 f32": flash_case(
            "Dk=Dv=32", (1, 4, 4, 77, 77, 32, 32), torch.float32),
        # rows 0..15 see no key: the kernel's final pass gives them what
        # the plain version's blocking gives them
        "no-key rows S=64 T=512 q_offset=-16 bf16": flash_case(
            "no-key rows", (2, lm_h, lm_kvh, 64, 512, lm_d, lm_d), bf16,
            q_offset=-16),
        "no-key rows S=64 T=512 q_offset=-16 f32": flash_case(
            "no-key rows f32", (2, lm_h, lm_kvh, 64, 512, lm_d, lm_d),
            torch.float32, q_offset=-16),
        "long B=1 S=T=4096 bf16": flash_case(
            "long", (1, lm_h, lm_kvh, 4096, 4096, lm_d, lm_d), bf16),
        "Dk=Dv=64 S=T=333 bf16": flash_case(
            "Dk=Dv=64", (2, 8, 2, 333, 333, 64, 64), bf16),
        "Dk=96 Dv=64 bf16": flash_case(
            "Dk=96 Dv=64 bf16", (2, 8, 4, 200, 200, 96, 64), bf16),
        # moonshot's prefill (phase 9): H = KVH, bf16 on flash_wgmma_kernel
        "moonshot B=1 H=KVH={} S=T={} D={} bf16".format(
            moe_dims[1], moe_dims[3], moe_dims[5]): flash_case(
            "moonshot", moe_dims, bf16),
        # deepseek's MLA prefill (phase 9) and training shape (phase 11e):
        # Dk nope + rope against Dv, at MLA's scale; bf16 on
        # flash_wgmma_kernel<192, 128>, f32 on the CUDA-core kernel
        "MLA B=1 H={} S=T={} Dk={} Dv={} bf16".format(
            mla_dims[1], mla_dims[3], mla_dims[5], mla_dims[6]): flash_case(
            "MLA", mla_dims, bf16, scale=mla_scale),
        "MLA B=1 H={} S=T={} Dk={} Dv={} f32".format(
            mla_dims[1], mla_dims[3], mla_dims[5], mla_dims[6]): flash_case(
            "MLA f32", mla_dims, torch.float32, scale=mla_scale),
        "MLA train B={} H={} S=T={} Dk={} Dv={} bf16".format(
            *mla_train_dims[:2], *mla_train_dims[3:4],
            *mla_train_dims[5:]): flash_case(
            "MLA train", mla_train_dims, bf16, scale=mla_scale),
        "MLA train B={} H={} S=T={} Dk={} Dv={} f32".format(
            *mla_train_dims[:2], *mla_train_dims[3:4],
            *mla_train_dims[5:]): flash_case(
            "MLA train f32", mla_train_dims, torch.float32, scale=mla_scale),
    }
    # paligemma's prefill (phase 10b): 8 heads over one kv head of 256, 256
    # patch rows + 64 tokens, bf16 on flash_wgmma_kernel<256, 256> and f32
    # on the CUDA-core kernel, and its training shape (phase 11g); hubert's
    # heads (16 of 80, bidirectional; bf16 on flash_wgmma_kernel<80, 80>)
    # at its training and encode shapes and at S=T=200, and causal at a
    # ragged S
    for dtype in (bf16, torch.float32):
        dt = str(dtype)[6:]
        for causal in (True, False):
            what = (f"paligemma B={PALI_BATCH} H={pali_h} KVH={pali_kvh} "
                    f"S=T={pali_s} D={pali_d} {'causal' if causal else 'non-causal'} "
                    f"{dt}")
            fa_err[what] = flash_case(what, pali_dims, dtype, causal=causal)
        what = (f"paligemma train B={TRAIN_BATCH} S=T={pali_train_dims[3]} "
                f"D={pali_d} {dt}")
        fa_err[what] = flash_case(what, pali_train_dims, dtype)
        for dims in (hu_train_dims, hu_encode_dims):
            what = (f"hubert B={dims[0]} H={hu_h} S=T={dims[3]} D={hu_d} "
                    f"non-causal {dt}")
            fa_err[what] = flash_case(what, dims, dtype, causal=False)
        what = f"hubert B=2 H=16 S=T=200 D=80 non-causal {dt}"
        fa_err[what] = flash_case(what, (2, 16, 16, 200, 200, 80, 80), dtype,
                                  causal=False)
        what = f"hubert heads B=2 H=4 S=T=77 D=80 ragged causal {dt}"
        fa_err[what] = flash_case(what, (2, 4, 4, 77, 77, 80, 80), dtype)
        fa_err[f"Dk=Dv=256 S=T=77 ragged causal {dt}"] = flash_case(
            "Dk=Dv=256 ragged", (1, 2, 1, 77, 77, 256, 256), dtype)
        fa_err[f"Dk=Dv=256 no-key rows S=64 T=512 q_offset=-16 {dt}"] = (
            flash_case("Dk=Dv=256 no-key rows", (2, pali_h, pali_kvh, 64, 512,
                                                 256, 256), dtype,
                       q_offset=-16))
    # a bf16 view that no tensor map describes (rows D + 1 elements apart):
    # the wrapper copies it contiguous, then launches the same kernel
    q, _, v = qkv(2, lm_h, lm_kvh, 300, 300, lm_d, lm_d, bf16)
    k = torch.from_numpy(rng.standard_normal((2, lm_kvh, 300, lm_d + 1)).astype(
        np.float32)).to(dev, bf16)[..., :lm_d]
    copies = fa_module.CONTIGUOUS_COPIES
    got = launched("flash_attention", lambda: flash_attention(q, k, v))
    check(fa_module.CONTIGUOUS_COPIES == copies + 1,
          "flash_attention: a view no tensor map describes was not copied once")
    want = flash_attention_plain(q, k, v)
    tol = 1e-5 * float(want.float().abs().max()) + 2.0 ** -7 * torch.maximum(
        got.float().abs(), want.float().abs())
    check(bool(((got.float() - want.float()).abs() <= tol).all()),
          f"flash_attention copied view: error {err(got, want)}")
    fa_err["row stride D+1 (copied) bf16"] = err(got, want)
    # a row of a batched call has the bits of the same row called alone
    # (the engine prefills one prompt, greedy_generate a batch): row 2 of
    # B = 4 against B = 1, at qwen's prefill shape in bf16 and f32 and at
    # moonshot's in bf16
    for dtype, dims in ((bf16, (lm_h, lm_kvh, lm_d, ENGINE_PROMPT)),
                        (torch.float32, (lm_h, lm_kvh, lm_d, ENGINE_PROMPT)),
                        (bf16, (moe_dims[1], moe_dims[2], moe_dims[5],
                                ENGINE_PROMPT)),
                        (bf16, (pali_h, pali_kvh, pali_d, pali_s)),
                        (torch.float32, (pali_h, pali_kvh, pali_d, pali_s))):
        h_, kvh_, d_, s_ = dims
        q, k, v = qkv(LM_BATCH, h_, kvh_, s_, s_, d_, d_, dtype)
        whole = launched("flash_attention", lambda: flash_attention(q, k, v))
        alone = launched("flash_attention", lambda: flash_attention(
            q[2:3], k[2:3], v[2:3]))
        check(torch.equal(whole[2:3], alone),
              f"flash_attention {dtype} H={h_} KVH={kvh_}: row 2 of B=4 "
              f"differs from the row alone")
    # the same at the MLA shape (B = 4 against row 2), with k built as the
    # MLA block builds it: the per-head part beside one rope slice
    # broadcast over the heads; no view is copied for a tensor map
    copies = fa_module.CONTIGUOUS_COPIES
    _, mla_h, _, mla_s, _, mla_dk, mla_dv = mla_dims
    mla_rope = get_arch(MOE_ARCHS[1][0]).qk_rope_head_dim
    q, k_nope, v = qkv(4, mla_h, mla_h, mla_s, mla_s, mla_dk - mla_rope,
                       mla_dv, bf16)
    q = torch.cat([q, torch.randn_like(q[..., :mla_rope])], dim=-1)
    rope = torch.randn((4, 1, mla_s, mla_rope), device=dev).to(bf16)
    k = torch.cat([k_nope, rope.expand(4, mla_h, mla_s, mla_rope)], dim=-1)
    whole = launched("flash_attention", lambda: flash_attention(
        q, k, v, scale=mla_scale))
    alone = launched("flash_attention", lambda: flash_attention(
        q[2:3], k[2:3], v[2:3], scale=mla_scale))
    check(torch.equal(whole[2:3], alone),
          "flash_attention MLA: row 2 of B=4 differs from the row alone")
    check(fa_module.CONTIGUOUS_COPIES == copies,
          "flash_attention MLA: a bf16 view was copied for a tensor map")
    max_err["flash_attention"] = fa_err["prefill B=4 S=T=256 bf16"]
    log("phase 2: flash_attention ok (B=1 bit-equal to row 2 of B=4 at "
        "S=T=256: qwen's heads in bf16 and f32, moonshot's and MLA's in "
        "bf16; at S=T=320 paligemma's in bf16 and f32; max abs err vs plain: "
        + ", ".join(f"{k} {v:.3g}" for k, v in fa_err.items()) + ")")

    # flash_attention_bwd (csrc/flash_attention_bwd.cu, the training path's
    # gradient) against autograd of the plain version on the same inputs,
    # through the differentiable wrapper as the model calls it: q, k, v
    # requiring grad (v the strided view the model passes), the forward
    # keeping its log-sum-exp, out.backward(dout).  The kernel sums in f32
    # and rounds each gradient once; the plain version's autograd on bf16
    # tensors rounds each q head's dk and dv to bf16 before the GQA sum (the
    # backward of its k.float()), several ulps off at a group of 4 or 8, so
    # the reference is the plain version's gradient of the same values taken
    # in f32.  The attention rule: gradients within 1e-5 of each one's max
    # |g|, bfloat16 ones within one bf16 ulp of each value plus that.  The
    # forward's out must keep its bits whether or not it writes the
    # log-sum-exp, and is held to the plain forward as flash_case holds
    # it; two calls must give the same bits, and a B = 1 call the
    # bits of row 2 of the batched one.
    def kernel_grads(q, k, v, dout, causal):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        before = common.LAUNCHES["flash_attention_bwd"]
        out = flash_attention(*leaves, causal=causal)
        out.backward(dout)
        torch.cuda.synchronize()
        check(common.LAUNCHES["flash_attention_bwd"] == before + 1,
              "flash_attention_bwd: the launch counter did not move by one")
        return out.detach(), [x.grad for x in leaves]

    def bwd_case(what, dims, dtype, causal=True):
        q, k, v = qkv(*dims, dtype)
        dout = torch.randn(q.shape[:3] + (v.shape[3],), device=dev).to(dtype)
        out, got = kernel_grads(q, k, v, dout, causal)
        with torch.no_grad():
            plain_out = flash_attention(q, k, v, causal=causal)
        check(torch.equal(out, plain_out),
              f"flash_attention {what}: the output with the log-sum-exp "
              f"written differs from the output without it")
        lse_err[f"{what} {str(dtype)[6:]}"] = held_to_plain(
            f"{what} with the log-sum-exp", out, q, k, v, causal=causal)
        want = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                         dout.float(), causal=causal)
        errs = []
        for name_, g, w in zip("qkv", got, want):
            check(g.shape == w.shape and g.dtype == dtype,
                  f"flash_attention_bwd {what}: d{name_} shape or dtype")
            g32, w32 = g.float(), w
            tol = 1e-5 * float(w32.abs().max())
            if dtype == torch.bfloat16:
                tol = tol + 2.0 ** -7 * torch.maximum(g32.abs(), w32.abs())
            check(bool(((g32 - w32).abs() <= tol).all())
                  and bool(torch.isfinite(g32).all()),
                  f"flash_attention_bwd {what}: d{name_} error {err(g, w)}")
            errs.append(err(g, w))
        return max(errs), (q, k, v, dout, got)

    sl_cfg = get_arch(TRAIN_ARCH)
    ex_cfg = example_config()
    sl_dims = (TRAIN_BATCH, sl_cfg.n_heads, sl_cfg.n_kv_heads, TRAIN_SEQ,
               TRAIN_SEQ, sl_cfg.head_dim, sl_cfg.head_dim)
    bwd_err = {}
    lse_err = {}
    bwd_inputs = {}
    for dtype in (bf16, torch.float32):
        dt = str(dtype)[6:]
        for label, dims, causal in (
                (f"stablelm B={TRAIN_BATCH} H=KVH={sl_cfg.n_heads} "
                 f"S=T={TRAIN_SEQ} D={sl_cfg.head_dim} causal", sl_dims, True),
                (f"qwen B=4 H={lm_h} KVH={lm_kvh} S=T=256 D={lm_d} causal",
                 (4, lm_h, lm_kvh, 256, 256, lm_d, lm_d), True),
                (f"example B=4 H={ex_cfg.n_heads} KVH={ex_cfg.n_kv_heads} "
                 f"S=T=64 D={ex_cfg.head_dim} causal",
                 (4, ex_cfg.n_heads, ex_cfg.n_kv_heads, 64, 64,
                  ex_cfg.head_dim, ex_cfg.head_dim), True),
                (f"hubert B=2 H={hu_cfg.n_heads} S=T=256 D={hu_cfg.head_dim} "
                 f"non-causal", (2, hu_cfg.n_heads, hu_cfg.n_kv_heads, 256,
                                 256, hu_cfg.head_dim, hu_cfg.head_dim), False),
                # hubert's training shape (phase 11f), and its heads causal
                # at a ragged S (partial tiles and the diagonal)
                (f"hubert train B={TRAIN_BATCH} H={hu_cfg.n_heads} "
                 f"S=T={TRAIN_SEQ} D={hu_cfg.head_dim} non-causal",
                 hu_train_dims, False),
                (f"hubert heads ragged B=2 H=4 S=T=77 D={hu_cfg.head_dim} "
                 f"causal", (2, 4, 4, 77, 77, hu_cfg.head_dim,
                             hu_cfg.head_dim), True),
                ("ragged B=2 H=4 KVH=2 S=T=77 D=32 causal",
                 (2, 4, 2, 77, 77, 32, 32), True),
                ("ragged B=1 H=2 KVH=1 S=T=100 D=96 causal",
                 (1, 2, 1, 100, 100, 96, 96), True),
                # deepseek's MLA (Dk 192, Dv 128; MLA's scale is Dk ** -0.5,
                # the kernel's default) at its training shape and phase 9's
                # prefill, and a ragged S
                (f"MLA train B={TRAIN_BATCH} H={mla_dims[1]} S=T={TRAIN_SEQ} "
                 f"Dk={mla_dims[5]} Dv={mla_dims[6]} causal", mla_train_dims,
                 True),
                (f"MLA prefill B=1 H={mla_dims[1]} S=T={mla_dims[3]} "
                 f"Dk={mla_dims[5]} Dv={mla_dims[6]} causal", mla_dims, True),
                ("MLA ragged B=2 H=4 S=T=77 Dk=192 Dv=128 causal",
                 (2, 4, 4, 77, 77, 192, 128), True),
                # paligemma's heads (8 over one kv head of 256) at its
                # training shape (phase 11g), its prefill and a ragged S
                (f"paligemma train B={TRAIN_BATCH} H={pali_h} KVH={pali_kvh} "
                 f"S=T={pali_train_dims[3]} D={pali_d} causal",
                 pali_train_dims, True),
                (f"paligemma prefill B={PALI_BATCH} H={pali_h} "
                 f"KVH={pali_kvh} S=T={pali_s} D={pali_d} causal", pali_dims,
                 True),
                ("paligemma ragged B=2 H=4 KVH=1 S=T=77 D=256 causal",
                 (2, 4, 1, 77, 77, 256, 256), True)):
            bwd_err[f"{label} {dt}"], bwd_inputs[label, dtype] = bwd_case(
                label, dims, dtype, causal)
    # two calls give the same bits; a B = 1 call the bits of row 2 of the
    # batched call (stablelm's, qwen's, deepseek's, paligemma's and hubert's
    # training shapes, bf16 and f32)
    for (label, dtype), (q, k, v, dout, got) in bwd_inputs.items():
        if not label.startswith(("stablelm", "qwen", "MLA train",
                                 "paligemma train", "hubert train")):
            continue
        causal = not label.endswith("non-causal")
        _, again = kernel_grads(q, k, v, dout, causal)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash_attention_bwd {label} {dtype}: two calls differ")
        _, alone = kernel_grads(q[2:3], k[2:3], v[2:3], dout[2:3], causal)
        check(all(torch.equal(a[2:3], b) for a, b in zip(got, alone)),
              f"flash_attention_bwd {label} {dtype}: a row of the batched "
              f"call differs from the row alone")
    del bwd_inputs
    # a pair the backward does not take (the forward does) raises; it never
    # falls back
    q, k, v = qkv(1, 2, 1, 32, 32, 256, 128, bf16)
    try:
        flash_attention(*(x.detach().requires_grad_() for x in (q, k, v)))
    except ValueError as e:
        check("ROADMAP.md queue 2 item 6" in str(e),
              f"flash_attention_bwd: the refusal does not name the roadmap: {e}")
    else:
        raise SmokeFailure("flash_attention accepted a gradient at (Dk, Dv) = "
                           "(256, 128), which the backward kernel does not "
                           "take")
    max_err["flash_attention_bwd"] = bwd_err[
        f"stablelm B={TRAIN_BATCH} H=KVH={sl_cfg.n_heads} S=T={TRAIN_SEQ} "
        f"D={sl_cfg.head_dim} causal bfloat16"]
    log("phase 2: flash_attention_bwd ok (output bits unchanged by the "
        "log-sum-exp, and that output against the plain forward: "
        + ", ".join(f"{k} {v:.3g}" for k, v in lse_err.items())
        + "; two calls bit-equal and a row alone bit-equal to the "
        "batched row at stablelm's, qwen's, deepseek's, paligemma's and "
        "hubert's training shapes, bf16 and f32; (Dk, Dv) = (256, 128) refused; max "
        "abs err vs autograd of the plain version: "
        + ", ".join(f"{k} {v:.3g}" for k, v in bwd_err.items()) + ")")

    # The three scans and decode attention against their plain versions.
    # Both sides compute in f32 and sum in another order (the rwkv kernel
    # takes the chunked form with decays as running products and its
    # products in three TF32 parts on the tensor cores, its plain version
    # the chunked log-decay form; tests/test_torch_rwkv_chunked.py holds
    # the kernel's algorithm within 1e-5 of max |y| on the CPU):
    # float32 outputs and every f32 state within 1e-5 of their largest
    # magnitude; bfloat16 outputs, which both round from f32, within one
    # bf16 ulp of each value plus the same 1e-5.
    def agree(what, got, want):
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{what}: shape or dtype {tuple(got.shape)} {got.dtype} vs "
              f"{tuple(want.shape)} {want.dtype}")
        g, w = got.float(), want.float()
        tol = 1e-5 * float(w.abs().max())
        if got.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * torch.maximum(g.abs(), w.abs())
        check(bool(((g - w).abs() <= tol).all()) and bool(torch.isfinite(g).all()),
              f"{what}: error {err(got, want)}")
        return err(got, want)

    def normal(*shape, dtype=torch.float32, sc=1.0):
        return torch.from_numpy(
            (sc * rng.standard_normal(shape)).astype(np.float32)).to(dev, dtype)

    rw_cfg = get_arch(RWKV_ARCH)
    rw_h, rw_d = rw_cfg.rwkv_heads, rw_cfg.rwkv_head_dim

    def rwkv_inputs(b, h, t, d, dtype):
        """r/k/v in ``dtype``, w = exp(-exp(w_log)) in f32 with w_log around
        the spec's w0 = -1, as the model makes them; u f32."""
        r, k, v = (normal(b, h, t, d, dtype=dtype, sc=0.5) for _ in range(3))
        w = torch.exp(-torch.exp(normal(b, h, t, d, sc=0.5) - 1.0))
        return r, k, v, w, normal(h, d, sc=0.5)

    rw_err = {}
    for dtype in (bf16, torch.float32):
        for b_, h_, t_, d_ in ((RWKV_BATCH, rw_h, RWKV_PROMPT, rw_d),
                               (RWKV_BATCH, rw_h, 1, rw_d),
                               (1, rw_h, ENGINE_PROMPT, rw_d),
                               (2, 8, 300, rw_d),
                               (2, 8, 300, 32), (2, 8, 1, 32),
                               (2, 8, 256, 32)):
            ins = rwkv_inputs(b_, h_, t_, d_, dtype)
            for state in ("absent", "zero", "random"):
                s0 = {"absent": None,
                      "zero": torch.zeros(b_, h_, d_, d_, device=dev),
                      "random": normal(b_, h_, d_, d_)}[state]
                got = launched("rwkv6_scan", lambda: rwkv6_scan(*ins, s0))
                want = rwkv6_scan_plain(*ins, s0)
                what = (f"rwkv6_scan {str(dtype)[6:]} B={b_} H={h_} T={t_} "
                        f"D={d_} state0 {state}")
                rw_err[what] = max(agree(what, got[0], want[0]),
                                   agree(what + " state", got[1], want[1]))
    # decays near 1 and near 0: w = exp(-exp(w_log)), w_log over [-6, 3]
    # (w from about 0.998 down to about 2e-9), where products of 32 decays
    # underflow; the same tolerances
    for dtype, (b_, h_, t_, d_) in ((bf16, (RWKV_BATCH, rw_h, RWKV_PROMPT, rw_d)),
                                    (torch.float32, (RWKV_BATCH, rw_h, RWKV_PROMPT, rw_d)),
                                    (bf16, (2, 8, 300, 32)),
                                    (torch.float32, (2, 8, 300, 32))):
        ins = list(rwkv_inputs(b_, h_, t_, d_, dtype))
        ins[3] = torch.exp(-torch.exp(torch.from_numpy(rng.uniform(
            -6.0, 3.0, (b_, h_, t_, d_)).astype(np.float32)).to(dev)))
        for state in ("absent", "random"):
            s0 = normal(b_, h_, d_, d_) if state == "random" else None
            got = launched("rwkv6_scan", lambda: rwkv6_scan(*ins, s0))
            want = rwkv6_scan_plain(*ins, s0)
            what = (f"rwkv6_scan extreme w {str(dtype)[6:]} B={b_} H={h_} "
                    f"T={t_} D={d_} state0 {state}")
            rw_err[what] = max(agree(what, got[0], want[0]),
                               agree(what + " state", got[1], want[1]))
    # views whose rows are not 16-byte aligned (D + 1 elements apart): the
    # kernel reads them from device memory instead of staging them
    for dtype in (bf16, torch.float32):
        wide = [normal(2, 8, 100, rw_d + 1, dtype=dtype, sc=0.5)[..., :rw_d]
                for _ in range(3)]
        wl = normal(2, 8, 100, rw_d + 1)[..., 1:]
        ins = (*wide, torch.exp(-torch.exp(wl - 1.0)), normal(8, rw_d, sc=0.5))
        got = launched("rwkv6_scan", lambda: rwkv6_scan(*ins))
        want = rwkv6_scan_plain(*ins)
        what = f"rwkv6_scan unaligned rows {str(dtype)[6:]} B=2 H=8 T=100 D={rw_d}"
        rw_err[what] = max(agree(what, got[0], want[0]),
                           agree(what + " state", got[1], want[1]))
    # a row of a batched call has the bits of the same row called alone:
    # row 2 of B = 4 against B = 1, the prefill (T = 256) and the step
    # (T = 1), from a random state, output and state, bf16 and f32
    for dtype in (bf16, torch.float32):
        for t_ in (ENGINE_PROMPT, 1):
            ins = rwkv_inputs(RWKV_BATCH, rw_h, t_, rw_d, dtype)
            s0 = normal(RWKV_BATCH, rw_h, rw_d, rw_d)
            whole = launched("rwkv6_scan", lambda: rwkv6_scan(*ins, s0))
            alone = launched("rwkv6_scan", lambda: rwkv6_scan(
                *(z[2:3] for z in ins[:4]), ins[4], s0[2:3]))
            check(all(torch.equal(w_[2:3], a_) for w_, a_ in zip(whole, alone)),
                  f"rwkv6_scan {dtype} T={t_}: row 2 of B=4 differs from the "
                  f"row alone")
    max_err["rwkv6_scan"] = max(v_ for k_, v_ in rw_err.items()
                                if f"H={rw_h} T={RWKV_PROMPT}" in k_
                                and "bfloat16" in k_ and "extreme" not in k_)
    log(f"phase 2: rwkv6_scan ok ({len(rw_err)} cases: bf16 and f32, state0 "
        f"absent, zero and random, T = 1, 256, 300, D = {rw_d} and 32, decays "
        f"near 1 and near 0, rows not 16-byte aligned; B=1 bit-equal to "
        f"row 2 of B=4 at T = 256 and 1; max abs "
        f"err vs plain {max(rw_err.values()):.3g}, at the prefill shape "
        f"{max_err['rwkv6_scan']:.3g})")

    # decode attention: qwen's decode shape in bf16, a ragged MHA T in f32,
    # T = 32768 and T = 1, the whole cache with partial=True (the combine
    # pass's unnormalized output where the plan splits T), and partial=True
    # over 4 T-shards combined against the full result.  Each case logs the
    # plan's (n_splits, keys_per_split).
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    da_plans = {}

    def decode_case(what, b_, h_, kvh_, t_, d_, dtype):
        q = normal(b_, h_, d_, dtype=dtype)
        k = normal(b_, kvh_, t_, d_, dtype=dtype)
        v = normal(b_, t_, kvh_, d_, dtype=dtype).transpose(1, 2)
        da_plans[what] = (t_,) + plan_decode_splits(kvh_, t_, n_sms)
        e = agree(f"decode_attention {what}",
                  launched("decode_attention", lambda: decode_attention(q, k, v)),
                  decode_attention_ref(q, k, v))
        whole = launched("decode_attention",
                         lambda: decode_attention(q, k, v, partial=True))
        for name, g, w_ in zip(("acc", "m", "l"), whole,
                               decode_attention_partial_ref(q, k, v)):
            agree(f"decode_attention {what} partial {name}", g, w_)
        if t_ < 4:                        # too short for 4 T-shards
            return e
        cuts = [i * t_ // 4 for i in range(5)]
        parts = [launched("decode_attention", lambda a=a, z=z: decode_attention(
            q, k[:, :, a:z], v[:, :, a:z], partial=True))
            for a, z in zip(cuts, cuts[1:])]
        for (acc, m_, l_), a, z in zip(parts, cuts, cuts[1:]):
            pa, pm, pl = decode_attention_partial_ref(q, k[:, :, a:z], v[:, :, a:z])
            for name, g, w_ in (("acc", acc, pa), ("m", m_, pm), ("l", l_, pl)):
                agree(f"decode_attention {what} partial {name}", g, w_)
        full_acc, _, full_l = decode_attention_partial_ref(q, k, v)
        merged = combine_partials(parts)[0]
        agree(f"decode_attention {what} 4 shards combined", merged, full_acc / full_l)
        return e

    da_err = {
        "qwen decode B=4 H=16 KVH=2 T=512 D=128 bf16": decode_case(
            "decode", LM_BATCH, lm_h, lm_kvh, LM_MAX_LEN, lm_d, bf16),
        "MHA B=2 H=KVH=8 T=300 D=128 f32": decode_case(
            "MHA", 2, 8, 8, 300, lm_d, torch.float32),
        "MQA B=1 H=12 KVH=1 T=77 Dk=Dv=256 f32": decode_case(
            "MQA", 1, 12, 1, 77, 256, torch.float32),
        "B=2 H=6 KVH=2 T=33 D=48 bf16": decode_case(
            "D=48", 2, 6, 2, 33, 48, bf16),
        "B=4 H=16 KVH=2 T=32768 D=128 bf16": decode_case(
            "T=32768", LM_BATCH, lm_h, lm_kvh, 32768, lm_d, bf16),
        "B=4 H=16 KVH=2 T=1 D=128 bf16": decode_case(
            "T=1", LM_BATCH, lm_h, lm_kvh, 1, lm_d, bf16),
        "MQA B=2 H=16 KVH=1 T=1000 D=128 bf16": decode_case(
            "MQA T=1000", 2, 16, 1, 1000, lm_d, bf16),
    }
    plans = da_plans.values()
    check(any(n == 1 for _, n, _ in plans) and any(n > 1 for _, n, _ in plans)
          and any(n > 1 and t_ % kps for t_, n, kps in plans),
          f"decode_attention plans miss a single split, a split T or a T that "
          f"is no multiple of keys_per_split: {da_plans}")
    # a row of a batched call has the bits of the same row called alone
    # (the split plan does not read B): B = 1 against row 2 of B = 4, the
    # output and the partial triple, in bf16 and f32
    batch_free = []
    for dtype in (bf16, torch.float32):
        for t_ in (LM_MAX_LEN, 4096, 32768):
            q = normal(LM_BATCH, lm_h, lm_d, dtype=dtype)
            k = normal(LM_BATCH, lm_kvh, t_, lm_d, dtype=dtype)
            v = normal(LM_BATCH, t_, lm_kvh, lm_d, dtype=dtype).transpose(1, 2)
            row = slice(2, 3)
            for partial in (False, True):
                whole = launched("decode_attention", lambda: decode_attention(
                    q, k, v, partial=partial))
                alone = launched("decode_attention", lambda: decode_attention(
                    q[row], k[row], v[row], partial=partial))
                pairs = zip(whole, alone) if partial else ((whole, alone),)
                check(all(torch.equal(w_[row], a_) for w_, a_ in pairs),
                      f"decode_attention T={t_} {dtype} partial={partial}: "
                      f"row 2 of B=4 differs from the row alone")
            batch_free.append(f"{str(dtype)[6:]} T={t_} "
                              f"{plan_decode_splits(lm_kvh, t_, n_sms)}")
    max_err["decode_attention"] = da_err["qwen decode B=4 H=16 KVH=2 T=512 D=128 bf16"]
    log("phase 2: decode_attention ok (B=1 bit-equal to row 2 of B=4, output "
        "and partial triple: " + ", ".join(batch_free) + "; partial over 4 "
        "T-shards combined equals the full result in every case; plans (n_splits, "
        "keys_per_split): " + ", ".join(f"{k_} {v_[1:]}" for k_, v_ in da_plans.items())
        + "; max abs err vs plain: "
        + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in da_err.items()) + ")")

    # decode attention with each row's lengths, as the model's decode step
    # calls it (q in the cache dtype, out in the compute dtype), against the
    # masked plain version (the step's own products): lengths 1, mid and T
    # (and 33, inside the first split), a ragged T, paligemma's D = 256 and
    # a cache of 32768 keys, whose splits past a short row's length load
    # nothing.  Both compute the model's weights (from the row's global max,
    # rounded to the cache dtype before the weighted sum) and sum in f32 in
    # other orders: within 1e-5 of max |v|, plus, for a bf16 cache, 2^-9 of
    # max |v| (a weight at a rounding boundary may round the other way) and,
    # for a bf16 output, one bf16 ulp of each value.  A row alone gets the
    # bits of the same row in a batch, and keys past a row's length are
    # never read (garbage there leaves the bits).
    dl_err = {}
    dl_plans = {}
    for dtype in (bf16, torch.float32):
        for label, (b_, h_, kvh_, t_, d_) in (
                (f"qwen step B={LM_BATCH} T={LM_MAX_LEN}",
                 (LM_BATCH, lm_h, lm_kvh, LM_MAX_LEN, lm_d)),
                ("ragged B=3 H=8 KVH=2 T=300 D=64", (3, 8, 2, 300, 64)),
                ("paligemma B=4 H=8 KVH=1 T=333 D=256", (4, 8, 1, 333, 256)),
                (f"long B={LM_BATCH} T=32768", (LM_BATCH, lm_h, lm_kvh, 32768,
                                                lm_d))):
            q = normal(b_, h_, d_, dtype=dtype)
            k = normal(b_, kvh_, t_, d_, dtype=dtype)
            v = normal(b_, kvh_, t_, d_, dtype=dtype)
            lens = torch.tensor([1, t_ // 2 + 1, t_, 33][:b_], device=dev)
            dl_plans[label] = plan_decode_splits(kvh_, t_, n_sms)
            want = decode_attention_masked_ref(q, k, v, lens,
                                               out_dtype=torch.float32)
            vmax = float(v.float().abs().max())
            for out_dtype in (dtype, torch.float32):
                got = launched("decode_attention", lambda: decode_attention(
                    q, k, v, lengths=lens, out_dtype=out_dtype))
                tol = (1e-5 + (2.0 ** -9 if dtype == bf16 else 0.0)) * vmax
                if out_dtype == bf16:
                    tol = tol + 2.0 ** -7 * torch.maximum(got.float().abs(),
                                                          want.abs())
                e = err(got, want)
                check(got.dtype == out_dtype and got.shape == (b_, h_, d_)
                      and bool(torch.isfinite(got.float()).all())
                      and bool(((got.float() - want).abs() <= tol).all()),
                      f"decode_attention lengths {label} {dtype} out "
                      f"{out_dtype}: error {e}")
                dl_err[f"{label} {str(dtype)[6:]} out {str(out_dtype)[6:]}"] = e
                for i in range(b_):
                    alone = launched("decode_attention", lambda: decode_attention(
                        q[i:i + 1], k[i:i + 1], v[i:i + 1], lengths=lens[i:i + 1],
                        out_dtype=out_dtype))
                    check(torch.equal(alone[0], got[i]),
                          f"decode_attention lengths {label} {dtype}: row {i} "
                          f"alone differs from the batched row")
            k2, v2 = k.clone(), v.clone()
            for i, n in enumerate(lens.tolist()):
                k2[i, :, n:] = 1e4
                v2[i, :, n:] = -1e4
            check(torch.equal(launched("decode_attention", lambda: decode_attention(
                q, k2, v2, lengths=lens)), launched("decode_attention",
                lambda: decode_attention(q, k, v, lengths=lens))),
                f"decode_attention lengths {label} {dtype}: keys past a row's "
                f"length changed its bits")
    check(dl_plans[f"long B={LM_BATCH} T=32768"][0] > 2,
          f"decode_attention lengths: the long cache has no splits past a "
          f"short row's length: {dl_plans}")
    max_err["decode_attention"] = dl_err[
        f"qwen step B={LM_BATCH} T={LM_MAX_LEN} bfloat16 out bfloat16"]
    log("phase 2: decode_attention with lengths ok (every row alone "
        "bit-equal to the batched row; keys past a row's length never read; "
        "plans (n_splits, keys_per_split): "
        + ", ".join(f"{k_} {v_}" for k_, v_ in dl_plans.items())
        + "; max abs err vs the masked plain version: "
        + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in dl_err.items()) + ")")

    # norm (csrc/norm.cu) against its plain versions, every form the models
    # run: RMS (apply_norm, MLA's latent norms), LayerNorm (apply_norm),
    # rwkv's per-head group norm (groups of 64, no bias) and the audio
    # frontend's one-group LayerNorm with a bias; bf16 and f32 at widths
    # 2048, 2560, 4096, 8192, the latent widths 512 and 1536 and hubert's
    # 1280, over a (4, 64, d) batch.  Both sides sum in f32 in other orders
    # and rsqrtf is within 2 ulp of the square root's reciprocal: agree's
    # rule (1e-5 of max |y|, and one bf16 ulp of each value in bf16).  A row
    # alone (B = 1) gets the bits of row 2 of the batch.  deepseek's latent
    # slice (models/mla.py: kv_a[..., :512] of (B, S, 512 + 64)) is read in
    # place: one launch a call, and a profiled call runs the norm kernel and
    # no copy before it.  The autograd backward (PyTorch ops on the kernel's
    # statistics) against autograd of the plain version in f32: 1e-5 of
    # each gradient's max.
    norm_err = {}
    for dtype in (bf16, torch.float32):
        for d_ in (2048, 2560, 4096, 8192, 512, 1536, 1280):
            x_ = (normal(4, 64, d_, sc=3.0) + 0.5).to(dtype)
            sc_, bi_ = normal(d_), normal(d_)
            for form, fn, ref in (
                    ("rms", lambda a: rms_norm(a, sc_, 1e-6),
                     lambda a: rms_norm_ref(a, sc_, 1e-6)),
                    ("layer", lambda a: layer_norm(a, sc_, bi_, 1e-5),
                     lambda a: layer_norm_ref(a, sc_, bi_, 1e-5)),
                    ("group 64", lambda a: group_norm(a, sc_, None, 64, 1e-5),
                     lambda a: group_norm_ref(a, sc_, None, 64, 1e-5)),
                    ("one group + bias", lambda a: group_norm(a, sc_, bi_, d_, 1e-5),
                     lambda a: group_norm_ref(a, sc_, bi_, d_, 1e-5))):
                what = f"norm {form} d={d_} {str(dtype)[6:]}"
                y_ = launched("norm", lambda: fn(x_))
                norm_err[what] = agree(what, y_, ref(x_))
                alone = launched("norm", lambda: fn(x_[2:3]))
                check(torch.equal(alone[0], y_[2]),
                      f"{what}: a row alone differs from row 2 of the batch")
        kv_a = (normal(4, 64, 576, sc=3.0) + 0.5).to(dtype)
        latent, sc_ = kv_a[..., :512], normal(512)
        what = f"norm latent slice d=512 of 576 {str(dtype)[6:]}"
        y_ = launched("norm", lambda: rms_norm(latent, sc_, 1e-6))
        norm_err[what] = agree(what, y_, rms_norm_ref(latent, sc_, 1e-6))
        alone = launched("norm", lambda: rms_norm(latent[2:3], sc_, 1e-6))
        check(torch.equal(alone[0], y_[2]),
              f"{what}: a row alone differs from row 2 of the batch")
        ran = device_kernels(torch, lambda: rms_norm(latent, sc_, 1e-6), 3)
        check(len(ran) == 3 and all(any(n in k for n in NORM_KERNEL_NAMES)
                                    for k in ran),
              f"{what}: three calls ran {ran}, not the norm kernel alone")
    for form in ("rms", "layer"):
        leaves = [normal(4, 16, 2048).requires_grad_(),
                  (normal(2048) + 1).requires_grad_(), normal(2048).requires_grad_()]
        fn, ref = ((rms_norm, rms_norm_ref) if form == "rms" else
                   (layer_norm, layer_norm_ref))
        args = leaves if form == "layer" else leaves[:2]
        dy = normal(4, 16, 2048)
        before = common.LAUNCHES["norm"]
        got = torch.autograd.grad(fn(*args, 1e-5), args, dy)
        check(common.LAUNCHES["norm"] == before + 1,
              f"norm {form} backward: the forward did not launch once")
        want_ = torch.autograd.grad(ref(*args, 1e-5), args, dy)
        for g_, w_ in zip(got, want_):
            check(err(g_, w_) <= 1e-5 * float(w_.abs().max()),
                  f"norm {form} backward: error {err(g_, w_)}")
    max_err["norm"] = norm_err["norm rms d=2048 bfloat16"]
    log("phase 2: norm ok (RMS, LayerNorm, groups of 64, one group with a "
        "bias; bf16 and f32 at d = 2048, 2560, 4096, 8192, 512, 1536, 1280; "
        "a row alone bit-equal to row 2 of the batch; deepseek's latent slice "
        "read in place, one norm kernel a call and no copy; autograd "
        "backward within 1e-5 of the plain version's; max abs err vs plain: "
        + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in norm_err.items()) + ")")

    # mamba_scan at jamba's width with the dtypes the jamba block passes
    # under bf16 (x bf16; delta, a, b, c, d f32; models/mamba.py:80-90).
    # d = 0 in the bf16 cases, so y is the scan's own output (the skip term
    # is the wrapper's plain PyTorch on both sides); the f32 cases keep d.
    # Each case logs plan_mamba's lanes and whether x and delta took the
    # kernel's 16-byte copies (rows_16b) or its element-wise path; both
    # paths and every lane count must run.  "extreme decays" draws
    # delta * a over [-150, -1e-5]: decays from 0 (below 2^-127) to
    # 0.99999, which compound over all T steps.  "decays near 1" draws
    # jamba's own ranges (delta in [1e-3, 1e-2] and a = -exp(A_log) in
    # [-16, -1], as mamba's A_log = log(1 .. 16) and its delta floor make
    # them), decays of 0.85 to 0.999, over one sequence of 4096 steps in
    # f32: the chain along which the kernel's approximate exponentials
    # (ex2.approx) could build up an error.
    mb_cfg = get_arch(MAMBA_ARCH)
    mb_dm, mb_n = mb_cfg.mamba_d_inner, mb_cfg.mamba_d_state

    def log_uniform(lo, hi, *shape):
        return torch.exp(torch.from_numpy(rng.uniform(
            math.log(lo), math.log(hi), shape).astype(np.float32))).to(dev)

    def ssm_inputs(b_, t_, dm, n_, dtype, delta_dtype=torch.float32,
                   decays=None):
        x_ = normal(b_, t_, dm, dtype=dtype, sc=0.5)
        if decays == "extreme":
            delta = log_uniform(1e-3, 5.0, b_, t_, dm)
            a_ = -log_uniform(1e-2, 30.0, dm, n_)
        elif decays == "near 1":
            delta = log_uniform(1e-3, 1e-2, b_, t_, dm)
            a_ = -log_uniform(1.0, 16.0, dm, n_)
        else:
            delta = normal(b_, t_, dm, sc=0.3).abs() + 0.1
            a_ = -(normal(dm, n_).abs() + 0.1)
        return (x_, delta.to(delta_dtype), a_, normal(b_, t_, n_, sc=0.5),
                normal(b_, t_, n_, sc=0.5))

    def mamba_plain(x_, delta, a_, bm, cm, d_, s0):
        yp, hp = mamba_scan_plain(x_, delta, a_, bm, cm, s0)
        return yp + (x_.float() * d_[None, None].float()).to(yp.dtype), hp

    f32 = torch.float32
    mb_err, mb_paths, mb_share = {}, {}, {}
    for what, (b_, t_, dm, n_, dtype, d_dtype, with_d, with_s0, decays) in {
            f"jamba engine prefill B=1 T=256 Dm={mb_dm} N={mb_n} x bf16": (
                1, 256, mb_dm, mb_n, bf16, f32, False, False, None),
            f"jamba width B=4 T=256 Dm={mb_dm} N={mb_n} x bf16": (
                4, 256, mb_dm, mb_n, bf16, f32, False, False, None),
            "jamba width B=4 T=256 state0 x bf16": (
                4, 256, mb_dm, mb_n, bf16, f32, False, True, None),
            "jamba width B=1 T=4096 x bf16": (
                1, 4096, mb_dm, mb_n, bf16, f32, False, False, None),
            "decays near 1 jamba width B=1 T=4096 f32 state0": (
                1, 4096, mb_dm, mb_n, f32, f32, False, True, "near 1"),
            "ragged B=2 T=100 Dm=300 N=16 x bf16 state0": (
                2, 100, 300, 16, bf16, f32, False, True, None),
            "B=2 T=50 Dm=301 N=16 x and delta bf16 state0": (
                2, 50, 301, 16, bf16, bf16, False, True, None),
            "B=2 T=100 Dm=1024 N=32 x bf16 state0": (
                2, 100, 1024, 32, bf16, f32, False, True, None),
            "extreme decays B=2 T=512 Dm=2048 N=16 f32 state0": (
                2, 512, 2048, 16, f32, f32, False, True, "extreme"),
            "B=2 T=100 Dm=300 N=8 f32 with D": (2, 100, 300, 8, f32, f32, True, True, None),
            "B=1 T=7 Dm=64 N=2 f32": (1, 7, 64, 2, f32, f32, True, False, None)}.items():
        ins = ssm_inputs(b_, t_, dm, n_, dtype, d_dtype, decays)
        d_ = normal(dm) if with_d else torch.zeros(dm, device=dev)
        s0 = normal(b_, dm, n_) if with_s0 else None
        got = launched("mamba_scan", lambda: mamba_scan(*ins, d_, s0))
        want = mamba_plain(*ins, d_, s0)
        mb_err[what] = max(agree(f"mamba_scan {what}", got[0], want[0]),
                           agree(f"mamba_scan {what} state", got[1], want[1]))
        # the f32 outputs' error as a share of the tolerance (<= 1 passes)
        mb_share[what] = max(err(g_, w_) / (1e-5 * float(w_.abs().max()))
                             for g_, w_ in zip(got, want) if g_.dtype == f32)
        copy16 = all(rows_16b(z.data_ptr(), dm, z.element_size()) for z in ins[:2])
        mb_paths[what] = (plan_mamba(b_, t_, dm, n_, n_sms).lanes,
                          "16-byte" if copy16 else "element")
    check({p[0] for p in mb_paths.values()} == {1, 2, 4}
          and {p[1] for p in mb_paths.values()} == {"16-byte", "element"},
          f"mamba_scan: phase 2 missed a lane count or a copy path: {mb_paths}")
    max_err["mamba_scan"] = mb_err[
        f"jamba engine prefill B=1 T=256 Dm={mb_dm} N={mb_n} x bf16"]
    # a row of a batched scan has the bits of the same row scanned alone
    # (the decode engine prefills one prompt, greedy_generate a batch;
    # plan_mamba's lanes do not read B): row 2 of B = 6 against B = 1 at
    # jamba's width, x bf16 and f32
    for dtype in (bf16, f32):
        ins = ssm_inputs(6, 256, mb_dm, mb_n, dtype)
        d_ = normal(mb_dm)
        whole = launched("mamba_scan", lambda: mamba_scan(*ins, d_))
        alone = launched("mamba_scan", lambda: mamba_scan(
            *(z[2:3] for z in ins[:2]), ins[2], *(z[2:3] for z in ins[3:]),
            d_))
        check(torch.equal(whole[0][2:3], alone[0])
              and torch.equal(whole[1][2:3], alone[1]),
              f"mamba_scan {dtype}: row 2 of B=6 differs from the row alone")
    log("phase 2: mamba_scan ok (B=1 bit-equal to row 2 of B=6 at jamba's "
        "width, x bf16 and f32; max abs err vs plain, f32 outputs' err over "
        "tolerance, [lanes, copy path]: " + ", ".join(
            f"{k_} {v_:.3g} {mb_share[k_]:.3f} {mb_paths[k_]}"
            for k_, v_ in mb_err.items()) + ")")

    # the scans' backward kernels (the training path's gradients) against
    # their plain versions (autograd through the plain forward) on the same
    # values in f32: f32 gradients within 1e-5 of their largest magnitude,
    # bf16 ones within one bf16 ulp more (agree: the plain gradient is
    # rounded to bf16 too); every call bit-equal to a second one.  rwkv's w
    # is drawn log-uniform in [0.05, 1), where the plain chunked form's dw
    # is accurate; the shapes are rwkv6-3b's and jamba's training shapes
    # (B = 8, T = 128) and ragged or narrow ones, D = 64 and 32, N = 16, 32
    # and 2, delta bf16 (the kernels' three entry points); rwkv's T = 256,
    # whose chunk states do not fit in shared memory beside the rest
    # (bwd_scratch_words > 0: they go to a scratch buffer); and rwkv on the
    # transposed (B, H, T, D) views the model passes (models/rwkv.py
    # _heads, and dy as autograd hands it), read in place: a profiled call
    # runs the backward's two kernels and no copy, and dr, dk, dv come back
    # in the views' layout.
    bwd_err = {}

    def twice(name, fn):
        first = launched(name, fn)
        again = launched(name, fn)
        check(all(torch.equal(a_, b_) for a_, b_ in zip(first, again)),
              f"{name}: a second call differs")
        return first

    rw_names = ("dr", "dk", "dv", "dw", "du")
    for dtype in (f32, bf16):
        for b_, h_, t_, d_ in ((TRAIN_BATCH, rw_h, TRAIN_SEQ, rw_d),
                               (2, 8, 77, rw_d), (2, 8, 40, 32),
                               (1, 2, 1, rw_d), (1, 4, 256, rw_d)):
            r_, k_, v_ = (normal(b_, h_, t_, d_, dtype=dtype, sc=0.5)
                          for _ in range(3))
            w_ = log_uniform(0.05, 1.0, b_, h_, t_, d_)
            u_, dy_ = normal(h_, d_, sc=0.5), normal(b_, h_, t_, d_, dtype=dtype)
            got = twice("rwkv6_scan_bwd",
                        lambda: rwkv6_scan_bwd(r_, k_, v_, w_, u_, dy_))
            want = rwkv6_scan_bwd_plain(*(z.float() for z in (r_, k_, v_, w_,
                                                              u_, dy_)))
            what = (f"rwkv6_scan_bwd {str(dtype)[6:]} B={b_} H={h_} T={t_} "
                    f"D={d_}")
            bwd_err[what] = max(agree(f"{what} {n_}", g_, w0_.to(g_.dtype))
                                for n_, g_, w0_ in zip(rw_names, got, want))
    check(bwd_scratch_words(256, rw_d, dev.index or 0) > 0
          and bwd_scratch_words(TRAIN_SEQ, rw_d, dev.index or 0) == 0,
          "rwkv6_scan_bwd: T = 256 should spill its chunk states and the "
          "training shape keep them in shared memory")
    b_, h_, t_, d_ = 2, 8, 77, rw_d
    r_, k_, v_, dy_ = (normal(b_, t_, h_, d_, dtype=bf16, sc=sc_).transpose(1, 2)
                       for sc_ in (0.5, 0.5, 0.5, 1.0))
    w_ = log_uniform(0.05, 1.0, b_, t_, h_, d_).transpose(1, 2)
    u_ = normal(h_, d_, sc=0.5)
    got = twice("rwkv6_scan_bwd", lambda: rwkv6_scan_bwd(r_, k_, v_, w_, u_, dy_))
    want = rwkv6_scan_bwd_plain(*(z.float() for z in (r_, k_, v_, w_, u_, dy_)))
    what = f"rwkv6_scan_bwd bfloat16 B={b_} H={h_} T={t_} D={d_} views"
    bwd_err[what] = max(agree(f"{what} {n_}", g_, w0_.to(g_.dtype))
                        for n_, g_, w0_ in zip(rw_names, got, want))
    check(all(g_.stride() == z.stride() for g_, z in zip(got, (r_, k_, v_, w_))),
          f"{what}: the gradients' strides {[g_.stride() for g_ in got]} are "
          f"not the views'")
    ran = device_kernels(torch, lambda: rwkv6_scan_bwd(r_, k_, v_, w_, u_, dy_), 1)
    check(len(ran) == 2 and all("rwkv6_" in k for k in ran),
          f"{what}: a call ran {ran}, not the backward's two kernels alone")
    # against the exact gradient where the chunked form is not: w drawn
    # log-uniform down to 1e-12, and with 5 % of it 0 (dw = d log w / w
    # would be infinite there; the kernel takes dw as the sum of G * S over
    # the columns, finite for any w), the sequential recurrence's gradient
    # in float64 the yardstick: every gradient within 1e-4 of its largest
    # magnitude.  The plain version's dw error is logged beside it.
    seq_err = {}
    for label, zero_share in (("w in [1e-12, 1)", 0.0),
                              ("w in [1e-12, 1), 5 % zeros", 0.05)):
        b_, h_, t_, d_ = 2, 4, TRAIN_SEQ, rw_d
        r_, k_, v_ = (normal(b_, h_, t_, d_, sc=0.5) for _ in range(3))
        w_ = log_uniform(1e-12, 1.0, b_, h_, t_, d_)
        w_ = torch.where(torch.rand(w_.shape, device=dev) < zero_share, 0.0, w_)
        u_, dy_ = normal(h_, d_, sc=0.5), normal(b_, h_, t_, d_)
        got = launched("rwkv6_scan_bwd",
                       lambda: rwkv6_scan_bwd(r_, k_, v_, w_, u_, dy_))
        exact = rwkv6_scan_seq_grad(r_, k_, v_, w_, u_, dy_)
        plain_dw = rwkv6_scan_bwd_plain(r_, k_, v_, w_, u_, dy_)[3]
        for n_, g_, e_ in zip(rw_names, got, exact):
            scale = float(e_.abs().max())
            e = err(g_, e_)
            check(e <= 1e-4 * scale and bool(torch.isfinite(g_).all()),
                  f"rwkv6_scan_bwd {label}: {n_} error {e} against max "
                  f"{scale} of the f64 sequential gradient")
            seq_err[f"{label} {n_}"] = e / scale
        pe = (plain_dw.double() - exact[3]).abs().max()
        seq_err[f"{label} plain dw"] = float(pe) / float(exact[3].abs().max())
    for dtype in (f32, bf16):
        for b_, t_, dm, n_, d_dtype in ((TRAIN_BATCH, TRAIN_SEQ, mb_dm, mb_n, f32),
                                        (2, 100, 300, 16, f32),
                                        (2, 50, 256, 32, f32),
                                        (2, 37, 200, 8, f32),
                                        (2, 41, 130, 4, f32),
                                        (1, 7, 64, 2, f32),
                                        (2, 50, 301, 16, dtype),
                                        (1, 300, 96, 16, f32)):
            ins = ssm_inputs(b_, t_, dm, n_, dtype, d_dtype)
            dy_ = normal(b_, t_, dm, dtype=dtype)
            got = twice("mamba_scan_bwd", lambda: mamba_scan_bwd(*ins, dy_))
            want = mamba_scan_bwd_plain(*(z.float() for z in ins), dy_.float())
            what = (f"mamba_scan_bwd {str(dtype)[6:]} B={b_} T={t_} Dm={dm} "
                    f"N={n_} delta {str(d_dtype)[6:]}")
            bwd_err[what] = max(
                agree(f"{what} {nm}", g_, w0_.to(g_.dtype)) for nm, g_, w0_ in
                zip(("dx", "ddelta", "da", "db", "dc"), got, want))
    check(mamba_scratch_words(1, 300, 96, 16) > 0
          and mamba_scratch_words(TRAIN_BATCH, TRAIN_SEQ, mb_dm, mb_n) == 0,
          "mamba_scan_bwd: T = 300 should spill its chunk states and the "
          "training shape keep them in shared memory")
    # b and c on bases that are not 16-byte aligned: no TMA box takes them,
    # so the launch takes the element loads, with the bits of aligned b, c
    ins = ssm_inputs(2, 50, 256, 16, bf16)
    dy_ = normal(2, 50, 256, dtype=bf16)
    shifted = tuple(torch.empty(z.numel() + 1, device=dev)[1:].view_as(z)
                    .copy_(z) for z in ins[3:])
    check(not rows_16b(shifted[0].data_ptr(), 16, 4),
          "mamba_scan_bwd: the shifted b should not be 16-byte aligned")
    got = mamba_scan_bwd(*ins[:3], *shifted, dy_)
    check(all(torch.equal(g_, w_) for g_, w_ in
              zip(got, mamba_scan_bwd(*ins, dy_))),
          "mamba_scan_bwd: b and c on unaligned bases changed the gradients")
    # through autograd, as the model calls them: the forward kernel and the
    # backward kernel once each, the gradients bit-equal to the backward's
    # own; a state0 under autograd is refused (no plain fallback)
    for name, fwd, bwd, ins in (
            ("rwkv6_scan", lambda *z: rwkv6_scan(*z)[0],
             lambda *z: rwkv6_scan_bwd(*z),
             (*(normal(2, 8, 77, rw_d, dtype=bf16, sc=0.5) for _ in range(3)),
              log_uniform(0.05, 1.0, 2, 8, 77, rw_d), normal(8, rw_d))),
            ("mamba_scan", lambda *z: selective_scan(*z)[0],
             lambda *z: mamba_scan_bwd(*z),
             ssm_inputs(2, 100, 300, 16, bf16))):
        leaves = [z.clone().requires_grad_() for z in ins]
        before = {k_: common.LAUNCHES[k_] for k_ in (name, name + "_bwd")}
        out = fwd(*leaves)
        dy_ = torch.randn_like(out)
        out.backward(dy_)
        torch.cuda.synchronize()
        check(all(common.LAUNCHES[k_] == before[k_] + 1 for k_ in before),
              f"{name} under autograd: launches moved "
              f"{ {k_: common.LAUNCHES[k_] - before[k_] for k_ in before} }, "
              f"expected one forward and one backward")
        direct = bwd(*ins, dy_)
        check(all(torch.equal(z.grad, g_.to(z.dtype))
                  for z, g_ in zip(leaves, direct)),
              f"{name} under autograd: gradients differ from {name}_bwd's")
        state0 = torch.zeros(
            (2, 8, rw_d, rw_d) if name == "rwkv6_scan" else (2, 300, 16),
            device=dev)
        try:
            (rwkv6_scan(*leaves, state0) if name == "rwkv6_scan"
             else selective_scan(*leaves, state0))
        except NotImplementedError:
            pass
        else:
            raise SmokeFailure(f"{name}: a state0 under autograd was not "
                               f"refused")
    max_err["rwkv6_scan_bwd"] = bwd_err[
        f"rwkv6_scan_bwd bfloat16 B={TRAIN_BATCH} H={rw_h} T={TRAIN_SEQ} D={rw_d}"]
    max_err["mamba_scan_bwd"] = bwd_err[
        f"mamba_scan_bwd bfloat16 B={TRAIN_BATCH} T={TRAIN_SEQ} Dm={mb_dm} "
        f"N={mb_n} delta float32"]
    log("phase 2: rwkv6_scan_bwd and mamba_scan_bwd ok (against autograd of "
        "the plain versions on the same values in f32, each bit-equal on a "
        "second call; max abs err: " + ", ".join(
            f"{k_} {v_:.3g}" for k_, v_ in bwd_err.items())
        + "); rwkv6_scan_bwd against the f64 sequential gradient (error / "
        "max |g|; the plain chunked version is no yardstick there, its dw "
        "beside): " + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in seq_err.items())
        + "; through autograd one forward and one backward launch each, "
        "bits equal; state0 under autograd refused")

    # the modes the sharded paths give flash_attention_bwd (q_offset) and
    # decode_attention (the T-split passes), at full-width shapes
    cp_and_t_split(torch, np, dev, card)

    # -- 2b. the four TinyBio kernels with a leading batch axis ---------------
    phase_done("2b")
    # Serving lifts each stage over a batch (torch.func.vmap); each card
    # kernel folds it into its own batch axis: ONE launch a call, each row
    # the bits of its request alone.  For B = 1, 2, 4, 8: the batched call
    # against B single calls on the card and against the plain version on
    # the whole batch, bit for bit (exact: the same sums in the same order);
    # the vmapped call against the batched call, bit for bit; and a
    # torch.profiler count of one device kernel for one batched call.
    xb_all = torch.from_numpy(np.stack([tinybio.synth_signal(x.numel(), s_)
                                        for s_ in range(8)])).to(dev)
    xib_all = int_tensor(-2 ** 15, 2 ** 15, (8, x.numel()), np.int16)
    qb_all = torch.from_numpy(rng.uniform(-1, 1, (8, 128, 36)).astype(np.float32)).to(dev)
    batched_kernels = {}
    for bsz in (1, 2, 4, 8):
        xb, xib, qb = xb_all[:bsz].contiguous(), xib_all[:bsz].contiguous(), qb_all[:bsz].contiguous()
        yb = launched("fir", lambda: fir(xb, h))
        check(same_bits(yb, fir_ref(xb, h)), f"batched fir B={bsz} vs plain")
        check(all(same_bits(yb[i_], fir(xb[i_], h)) for i_ in range(bsz)),
              f"batched fir B={bsz} vs single calls")
        check(same_bits(launched("fir", lambda: torch.func.vmap(lambda a_: fir(a_, h))(xb)), yb),
              f"vmapped fir B={bsz}")
        yib = launched("fir", lambda: fir(xib, hi))
        check(torch.equal(yib, fir_ref(xib, hi)), f"batched fir Q15 int16 B={bsz} vs plain")
        check(all(torch.equal(yib[i_], fir(xib[i_], hi)) for i_ in range(bsz)),
              f"batched fir Q15 int16 B={bsz} vs single calls")
        # extrema at both edges of every row: a peak at sample 0, a trough
        # at sample 1 and a peak at the last sample, which a flattened
        # (B * n) signal would flag as interior samples
        ye = yb.clone()
        ye[:, 0], ye[:, 1], ye[:, -1], ye[:, -2] = 9.0, -9.0, 9.0, -9.0
        fb = launched("delineate", lambda: delineate(ye, 0))
        check(torch.equal(fb, delineate_ref(ye, 0)), f"batched delineate B={bsz} vs plain")
        check(all(torch.equal(fb[i_], delineate(ye[i_], 0)) for i_ in range(bsz)),
              f"batched delineate B={bsz} vs single calls")
        check(bool((fb[:, 0] == 0).all() and (fb[:, -1] == 0).all()
                   and (fb[:, -2] == -1).all()), f"batched delineate B={bsz}: row edges")
        check(torch.equal(launched("delineate", lambda: torch.func.vmap(
            lambda a_: delineate(a_, 0))(ye)), fb), f"vmapped delineate B={bsz}")
        wb = yb.reshape(bsz, 128, 512)
        pb = launched("stockham_fft", lambda: power_spectrum(wb))
        check(all(same_bits(pb[i_], power_spectrum(wb[i_])) for i_ in range(bsz)),
              f"batched power_spectrum B={bsz} vs single calls")
        pre_, pim_ = stockham_fft_ref(wb.reshape(-1, 512), torch.zeros(bsz * 128, 512, device=dev))
        pref = (pre_ * pre_ + pim_ * pim_).reshape(bsz, 128, 512)
        # the fft's 1e-6 of max |X| carried through the square: 3e-6 of
        # max |X|^2
        check(float((pb - pref).abs().max()) <= 3e-6 * float(pref.max()),
              f"batched power_spectrum B={bsz} vs plain (3e-6 of max |X|^2)")
        check(same_bits(launched("stockham_fft", lambda: torch.func.vmap(power_spectrum)(wb)), pb),
              f"vmapped power_spectrum B={bsz}")
        for what_b, bb in (("b card tensor", b), ("b float", 0.1)):
            sb = launched("svm", lambda: svm_decision(qb, sv_main, alpha_main, bb, 0.5))
            check(all(same_bits(sb[i_], svm_decision(qb[i_], sv_main, alpha_main, bb, 0.5))
                      for i_ in range(bsz)), f"batched svm B={bsz} ({what_b}) vs single calls")
            check(torch.allclose(sb, svm_decision_ref(qb, sv_main, alpha_main, bb, 0.5),
                                 rtol=1e-4, atol=1e-5), f"batched svm B={bsz} ({what_b}) vs plain")
            check(same_bits(launched("svm", lambda: torch.func.vmap(
                lambda a_: svm_decision(a_, sv_main, alpha_main, bb, 0.5))(qb)), sb),
                f"vmapped svm B={bsz} ({what_b})")
        for name_, fn_, marker_ in (
                ("fir", lambda: fir(xb, h), "fir_kernel"),
                ("fir Q15", lambda: fir(xib, hi), "fir_kernel"),
                ("delineate", lambda: delineate(ye, 0), "delineate_kernel"),
                ("power_spectrum", lambda: power_spectrum(wb), "stockham_fft_kernel"),
                ("svm", lambda: svm_decision(qb, sv_main, alpha_main, b, 0.5), "svm_kernel")):
            names_ = device_kernels(torch, fn_, 1)
            check(len(names_) == 1 and marker_ in names_[0],
                  f"batched {name_} B={bsz} ran device kernels {names_}")
        batched_kernels[bsz] = 5
    log("phase 2: batched TinyBio kernels ok for B = 1, 2, 4, 8: fir (f32 and Q15 "
        "int16), delineate (extrema at the row edges), power_spectrum (B, 128, 512) "
        "and svm (B, 128, 36; b a card tensor and a float) bit-equal to B single "
        "calls, fir/delineate bit-equal to the plain version on the batch "
        "(power_spectrum within 3e-6 of max |X|^2, svm rtol 1e-4 + atol 1e-5), "
        "vmapped calls bit-equal to batched ones, one device kernel a batched call")

    # -- 3. timings at the main paths' shapes ------------------------------
    phase_done("3")
    n, taps = x.numel(), h.numel()
    q, m, d = feats.shape[0], sv_main.shape[0], feats.shape[1]
    bw, bn = w.shape
    timed = {
        "fir": dict(
            kernel=lambda: fir(x, h), plain=lambda: fir_ref(x, h),
            library=lambda: F.conv1d(x.view(1, 1, -1), h.flip(0).view(1, 1, -1),
                                     padding=taps - 1),
            bound=bound(4.0 * (2 * n + taps), 2.0 * n * taps)),
        "delineate": dict(
            kernel=lambda: delineate(y, 0), plain=lambda: delineate_ref(y, 0),
            library=None, bound=bound(5.0 * n, 7.0 * n)),
        "stockham_fft": dict(
            kernel=lambda: fft(w),
            plain=lambda: stockham_fft_ref(w, torch.zeros_like(w)),
            library=lambda: torch.fft.fft(w),
            bound=bound(4.0 * 3 * bw * bn,
                        10.0 * bw * (bn // 2) * int(math.log2(bn)))),
        "svm": dict(
            kernel=lambda: svm_decision(feats, sv_main, alpha_main, b, 0.5),
            plain=lambda: svm_decision_ref(feats, sv_main, alpha_main, b, 0.5),
            library=None,
            bound=bound(4.0 * (q * d + m * d + m + q),
                        2.0 * q * m * d + 2.0 * (q + m) * d + 8.0 * q * m)),
    }
    rows = {}
    fmt = lambda v: "-" if v is None else f"{v:.6f} ms"
    for name, t in timed.items():
        # device time from CUDA-graph replay (the numbers reported), and the
        # eager per-call cost with the host's dispatch (logged beside them)
        ms = device_ms(torch, t["kernel"], 100)
        plain_ms = device_ms(torch, t["plain"], 5)
        lib_ms = (device_ms(torch, t["library"], 100)
                  if t["library"] is not None else None)
        eager = [call_ms(torch, t["kernel"], 300),
                 call_ms(torch, t["plain"], 30, warmup=3),
                 None if t["library"] is None else call_ms(torch, t["library"], 300)]
        bound_ms, bound_by = t["bound"]
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        log(f"phase 3: {name}: device time per call: kernel {fmt(ms)}, "
            f"plain {fmt(plain_ms)}, library {fmt(lib_ms)}; bound "
            f"{bound_ms:.6f} ms ({bound_by}); eager call incl. host "
            f"dispatch: kernel {fmt(eager[0])}, plain {fmt(eager[1])}, "
            f"library {fmt(eager[2])}")
    # fir's bits forbid the fused multiply-add: an FMUL and an FADD per tap
    # and output (the Q15 path: one IMAD at half that rate), so its own
    # bound is twice the FMA bound of the kernels line
    log(f"phase 3: fir plan {tuple(plan_fir(n, taps, n_sms))} (rows a thread, "
        f"threads a block); bound of its bits (FMUL + FADD at 128 a "
        f"clock per SM, or IMAD at 64) {fir_bits_bound(n, taps, n_sms, max_sm_mhz):.6f} "
        f"ms beside the FMA bound {rows['fir']['bound_ms']:.6f} ms; Q15 int16 at "
        f"the same shape: kernel "
        f"{fmt(device_ms(torch, lambda: fir(xi, hi), 100))}, plain "
        f"{fmt(device_ms(torch, lambda: fir_ref(xi, hi), 5))}")

    # power_spectrum (TinyBio's stage-3 call: the fft kernel with |X|^2 in
    # its last pass, one launch) beside fft; its "library" is the parent's
    # composition, fft and then re*re + im*im (four launches).  Bound: the
    # windows read once and the spectrum written once, against the fft's
    # flops and 3 a sample.
    def squares(r_, i_):
        return r_ * r_ + i_ * i_

    ps_bound = bound(4.0 * 2 * bw * bn, 10.0 * bw * (bn // 2) * int(math.log2(bn))
                     + 3.0 * bw * bn)
    ps_row = dict(
        ms=device_ms(torch, lambda: power_spectrum(w), 100),
        plain_ms=device_ms(torch, lambda: squares(*stockham_fft_ref(
            w, torch.zeros_like(w))), 5),
        library_ms=device_ms(torch, lambda: squares(*fft(w)), 100),
        bound_ms=ps_bound[0], bound_by=ps_bound[1])
    log(f"phase 3: power_spectrum {bw} x {bn}: device time per call: kernel "
        f"{fmt(ps_row['ms'])}, plain {fmt(ps_row['plain_ms'])}, fft then "
        f"re*re + im*im (the parent's four launches) {fmt(ps_row['library_ms'])}; "
        f"bound {ps_bound[0]:.6f} ms ({ps_bound[1]}); eager call incl. host "
        f"dispatch: kernel {fmt(call_ms(torch, lambda: power_spectrum(w), 300))}")
    # the card's launch floor: an empty kernel (csrc/launch_floor.cu) of one
    # block of 32 threads and of TinyBio's fft/svm grid, 128 blocks of 256,
    # timed as the kernels are (100 a graph)
    floor = launch_floor(common)
    floor_ms = {g_: device_ms(torch, lambda g_=g_: floor(*g_), 100)
                for g_ in ((1, 32), (128, 256))}
    log("phase 3: launch floor (empty kernel): device time per call: "
        + ", ".join(f"{b_} x {t_} threads {v_:.6f} ms" for (b_, t_), v_ in floor_ms.items())
        + "; over the 1-block floor: " + ", ".join(
            f"{k_} {rows[k_]['ms'] / floor_ms[1, 32]:.2f}x" for k_ in TINYBIO_KERNELS)
        + f", power_spectrum {ps_row['ms'] / floor_ms[1, 32]:.2f}x")
    # one device kernel per call of svm_decision, power_spectrum, fir and
    # delineate (torch.profiler over 10 calls)
    for what, fn_, marker in (
            ("svm_decision", timed["svm"]["kernel"], "svm_kernel"),
            ("power_spectrum", lambda: power_spectrum(w), "stockham_fft_kernel"),
            ("fir", timed["fir"]["kernel"], "fir_kernel"),
            ("delineate", timed["delineate"]["kernel"], "delineate_kernel")):
        names = device_kernels(torch, fn_, 10)
        check(len(names) == 10 and all(marker in k_ for k_ in names),
              f"{what}: 10 calls ran {len(names)} device kernels: {sorted(set(names))}")
        log(f"phase 3: {what}: 10 calls ran 10 device kernels ({names[0][:60]})")

    # the batched calls at B = 4 (phase 7's micro-batch): device time of one
    # batched call beside four single calls and the launch floor
    xb4, xib4 = xb_all[:4].contiguous(), xib_all[:4].contiguous()
    yb4 = fir(xb4, h)
    wb4, qb4 = yb4.reshape(4, 128, 512), qb_all[:4].contiguous()
    batched_ms = {}
    for name_, one_, four_ in (
            ("fir", lambda: fir(x, h), lambda: fir(xb4, h)),
            ("fir Q15 int16", lambda: fir(xi, hi), lambda: fir(xib4, hi)),
            ("delineate", lambda: delineate(y, 0), lambda: delineate(yb4, 0)),
            ("power_spectrum", lambda: power_spectrum(w), lambda: power_spectrum(wb4)),
            ("svm", lambda: svm_decision(feats, sv_main, alpha_main, b, 0.5),
             lambda: svm_decision(qb4, sv_main, alpha_main, b, 0.5))):
        one_ms, four_ms = device_ms(torch, one_, 100), device_ms(torch, four_, 100)
        batched_ms[name_] = (four_ms, one_ms)
        log(f"phase 3: batched {name_} B=4: device time per call {four_ms:.6f} ms, "
            f"4 x the single call {4 * one_ms:.6f} ms (single {one_ms:.6f} ms), "
            f"{four_ms / floor_ms[1, 32]:.2f}x the 1 x 32 launch floor")

    # gemm at the GeMM path's 256^3 int32, once per config's tiling; the
    # kernels line reports the 16T tiling (the quickstart's config).
    side = 256
    ga, gb = ints(-64, 64, side, side), ints(-64, 64, side, side)
    per_cfg = {name: device_ms(torch, lambda k=k: gemm(ga, gb, k), 100)
               for name, k in knobs.items()}
    k16 = knobs[EGPU_16T.name]
    int_library = None
    try:
        torch.matmul(ga[:2, :2], gb[:2, :2])
    except (NotImplementedError, RuntimeError) as e:
        log(f"phase 3: gemm int32 library call: none — torch.matmul on CUDA "
            f"int32 raises {type(e).__name__}: {str(e).splitlines()[0][:80]}")
    else:
        int_library = lambda: torch.matmul(ga, gb)
    g_bound = bound(4.0 * 3 * side * side, float(side) ** 3, peak_int32_macs)
    rows["gemm"] = dict(
        ms=per_cfg[EGPU_16T.name],
        plain_ms=device_ms(torch, lambda: gemm_plain(ga, gb), 5),
        library_ms=(None if int_library is None
                    else device_ms(torch, int_library, 100)),
        bound_ms=g_bound[0], bound_by=g_bound[1])
    r = rows["gemm"]
    log(f"phase 3: gemm 256^3 int32: device time per call: kernel "
        + ", ".join(f"{c} {v:.6f} ms ({tuple(plan_split_k(side, side, side, tiles_from_knobs(k), n_sms, torch.int32))} "
                    f"splits, k-tiles)" for (c, v), k in zip(per_cfg.items(), knobs.values()))
        + f"; plain {fmt(r['plain_ms'])}, library {fmt(r['library_ms'])}; "
        f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}, int32 peak); eager "
        f"call incl. host dispatch: kernel 16T "
        f"{fmt(call_ms(torch, lambda: gemm(ga, gb, k16), 300))}, plain "
        f"{fmt(call_ms(torch, lambda: gemm_plain(ga, gb), 30, warmup=3))}")
    # ... and at 2048^3 with the 16T tiling, where launch latency no longer
    # hides the kernel's own rate.  int32 exact against the plain version;
    # f32 against torch.matmul (TF32 off): sums of 2048 products of N(0, 1)
    # values reach |c| ~ 200, where the two summation orders differ by a few
    # 1e-5, so rtol 1e-4 and atol 1e-3.
    big = 2048
    ba, bb = ints(-64, 64, big, big), ints(-64, 64, big, big)
    fa, fb = floats(big, big), floats(big, big)
    check(torch.equal(launched("gemm", lambda: gemm(ba, bb, k16)), gemm_plain(ba, bb)),
          "gemm int32 2048^3 not exact")
    check(torch.allclose(launched("gemm", lambda: gemm(fa, fb, k16)),
                         torch.matmul(fa, fb), rtol=1e-4, atol=1e-3),
          "gemm f32 2048^3 differs from torch.matmul")
    big_rows = {}
    for dtype, (xa, xb, peak, ops) in {
            "int32": (ba, bb, peak_int32_macs, float(big) ** 3),
            "f32": (fa, fb, PEAK_FP32_FLOPS, 2.0 * float(big) ** 3)}.items():
        k_ms = device_ms(torch, lambda: gemm(xa, xb, k16), 10)
        lib = (None if dtype == "int32"
               else device_ms(torch, lambda: torch.matmul(fa, fb), 10))
        b_ms, b_by = bound(4.0 * 3 * big * big, ops, peak)
        big_rows[dtype] = dict(ms=k_ms, library_ms=lib, bound_ms=b_ms)
        log(f"phase 3: gemm 2048^3 {dtype} (16T tiling): kernel {k_ms:.6f} ms "
            f"({ops / (k_ms * 1e-3) / 1e12:.3f} T {'MAC' if dtype == 'int32' else 'FLOP'}/s), "
            f"library {fmt(lib)}, bound {b_ms:.6f} ms ({b_by})")

    # flash_attention at qwen's prefill shape (the kernels line reports it)
    # and at B=1, S=T=4096.  Bound: q, k, v read once and the output
    # written once in bf16 over 3.35 TB/s, against 2 (Dk + Dv) flops for
    # each (q, k) pair the mask keeps (causal, or all S x T) over the bf16
    # peak.
    def mask_pairs(s, t, causal):
        return sum(min(t, i + 1) for i in range(s)) if causal else s * t

    def fa_bound(b, h, kvh, s, t, dk, dv, lse=False, causal=True):
        nbytes = 2.0 * (b * h * s * dk + b * kvh * t * (dk + dv) + b * h * s * dv)
        nbytes += 4.0 * b * h * s if lse else 0.0       # the training forward's
        return bound(nbytes, 2.0 * b * h * mask_pairs(s, t, causal) * (dk + dv),
                     PEAK_BF16_FLOPS)

    def sdpa(q, k, v, scale=None, causal=True):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True, scale=scale)

    # hubert's heads (16 of 80, bidirectional): its encode shape (phase
    # 11c) and its training shape (11f), hu_encode_dims and hu_train_dims
    fa_rows = {}
    for label, dims, scale, per_graph, causal in (
            ("prefill", (LM_BATCH, lm_h, lm_kvh, LM_PROMPT, LM_PROMPT, lm_d,
                         lm_d), None, 50, True),
            ("long", (1, lm_h, lm_kvh, 4096, 4096, lm_d, lm_d), None, 3, True),
            # SDPA takes Dv != Dk (its flash backend does not; PyTorch picks
            # another)
            ("MLA", mla_dims, mla_scale, 20, True),
            # paligemma's prefill: Dk = Dv = 256 on flash_wgmma_kernel
            ("paligemma", pali_dims, None, 20, True),
            # hubert's encode: Dk = Dv = 80 on flash_wgmma_kernel
            ("hubert encode", hu_encode_dims, None, 20, False),
            # the training forwards, keeping the log-sum-exp for the
            # backward: stablelm's (phase 11a), deepseek's (11e),
            # paligemma's (11g) and hubert's (11f)
            ("stablelm train", sl_dims, None, 20, True),
            ("MLA train", mla_train_dims, mla_scale, 20, True),
            ("paligemma train", pali_train_dims, None, 20, True),
            ("hubert train", hu_train_dims, None, 20, False)):
        b_, h_, kvh_, s_, _, dk_, dv_ = dims
        train = label.endswith("train")
        q, k, v = (x.contiguous() for x in qkv(*dims, bf16))
        check(err(sdpa(q, k, v, scale, causal),
                  flash_attention_plain(q, k, v, scale=scale,
                                        causal=causal)) <= 5e-2,
              f"SDPA differs from the plain version at {label}")
        b_ms, b_by = fa_bound(*dims, lse=train, causal=causal)
        kernel = ((lambda: _card_forward(
            q, k, v, causal, dk_ ** -0.5 if scale is None else scale, 0, s_,
            s_, with_lse=True)) if train
            else (lambda: flash_attention(q, k, v, scale=scale,
                                          causal=causal)))
        fa_rows[label] = dict(
            ms=device_ms(torch, kernel, per_graph),
            plain_ms=device_ms(torch, lambda: flash_attention_plain(
                q, k, v, scale=scale, causal=causal), 1),
            library_ms=device_ms(torch, lambda: sdpa(q, k, v, scale, causal),
                                 per_graph),
            bound_ms=b_ms, bound_by=b_by)
        r = fa_rows[label]
        log(f"phase 3: flash_attention {label} B={b_} H={h_} KVH={kvh_} "
            f"S=T={s_} Dk={dk_} Dv={dv_} bf16 "
            f"{'causal' if causal else 'non-causal'}"
            + (" (keeping the log-sum-exp)" if train else "")
            + ": device time per call: "
            f"kernel {fmt(r['ms'])}, plain {fmt(r['plain_ms'])}, library "
            f"(SDPA) {fmt(r['library_ms'])}; bound {b_ms:.6f} ms ({b_by}); "
            f"kernel {r['ms'] / b_ms:.1f}x its bound ({b_ms / r['ms']:.3f} of "
            f"it), {r['ms'] / r['library_ms']:.2f}x SDPA")
    rows["flash_attention"] = fa_rows["prefill"]

    # flash_attention_bwd at stablelm-1.6b's training shape (the kernels line
    # reports it), bf16, causal, from the forward kernel's log-sum-exp.
    # Bound: q, k, v, dout read once and dq, dk, dv written once in bf16 (and
    # the f32 lse read once) over 3.35 TB/s, against the five products a
    # backward needs (QK^T again, dO V^T, P^T dO, dS K, dS^T Q: 2 (3 Dk +
    # 2 Dv) flops per (q, k) pair the causal mask keeps) over the bf16
    # peak; q, dq and k, dk are Dk wide, dout and v, dv Dv wide.  The
    # plain version is autograd through flash_attention_plain (its forward
    # included: the backward needs it); the library's is
    # scaled_dot_product_attention's backward, timed as its forward and
    # backward together less its forward.
    def fa_bwd_bound(b, h, kvh, s, t, dk, dv=None, causal=True):
        dv = dk if dv is None else dv
        nbytes = 2.0 * (b * h * s * (2 * dk + dv)
                        + 2 * b * kvh * t * (dk + dv)) + 4.0 * b * h * s
        return bound(nbytes, 2.0 * b * h * mask_pairs(s, t, causal)
                     * (3 * dk + 2 * dv), PEAK_BF16_FLOPS)

    b_, h_, kvh_, s_, _, d_, _ = sl_dims
    q, k, v = (x.contiguous() for x in qkv(*sl_dims, bf16))
    dout = torch.randn_like(q)
    _, lse = _card_forward(q, k, v, True, d_ ** -0.5, 0, s_, s_,
                           with_lse=True)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                             enable_gqa=True)
        return torch.autograd.grad(out, (qg, kg, vg), dout)

    lib_grads = sdpa_fwd_bwd()
    plain_grads = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                            dout.float())
    check(all(err(a, b) <= 1e-2 * float(b.abs().max())
              for a, b in zip(lib_grads, plain_grads)),
          "SDPA's gradient differs from the plain version's at stablelm's "
          "training shape")
    bb_ms, bb_by = fa_bwd_bound(b_, h_, kvh_, s_, s_, d_)
    lib_fb = device_ms(torch, sdpa_fwd_bwd, 20)
    lib_f = device_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    rows["flash_attention_bwd"] = dict(
        ms=device_ms(torch, lambda: flash_attention_bwd(q, k, v, dout, lse),
                     20),
        plain_ms=device_ms(torch, lambda: flash_attention_bwd_plain(
            q, k, v, dout), 1),
        library_ms=lib_fb - lib_f, bound_ms=bb_ms, bound_by=bb_by)
    r = rows["flash_attention_bwd"]
    fwd_ms = device_ms(torch, lambda: flash_attention(q, k, v), 20)
    log(f"phase 3: flash_attention_bwd stablelm B={b_} H=KVH={h_} S=T={s_} "
        f"D={d_} bf16 causal: device time per call: kernel {fmt(r['ms'])} "
        f"(two device kernels), plain {fmt(r['plain_ms'])} (autograd through "
        f"the plain forward), library (SDPA backward: forward + backward "
        f"{lib_fb:.6f} less forward {lib_f:.6f}) {fmt(r['library_ms'])}; "
        f"bound {bb_ms:.6f} ms ({bb_by}); kernel {r['ms'] / bb_ms:.1f}x its "
        f"bound, {r['ms'] / r['library_ms']:.2f}x SDPA's backward; the "
        f"forward kernel at this shape {fwd_ms:.6f} ms")

    _, _, per_kernel = device_profile(torch, lambda: [
        flash_attention_bwd(q, k, v, dout, lse) for _ in range(20)])
    log("phase 3: flash_attention_bwd stablelm, device us a call by kernel "
        "(torch.profiler over 20 calls): " + ", ".join(
            f"{kernel_name(k_)} {v_ / 20:.2f}"
            for k_, v_ in sorted(per_kernel.items(), key=lambda kv: -kv[1])))
    # qwen's GQA training shape (16 over 2 heads of 128, S = T = 256, B = 4)
    gqa_dims = (4, lm_h, lm_kvh, 256, 256, lm_d, lm_d)
    q, k, v = (x.contiguous() for x in qkv(*gqa_dims, bf16))
    dout = torch.randn_like(q)
    _, lse = _card_forward(q, k, v, True, lm_d ** -0.5, 0, 256, 256,
                           with_lse=True)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    g_bound = fa_bwd_bound(4, lm_h, lm_kvh, 256, 256, lm_d)
    g_ms = device_ms(torch, lambda: flash_attention_bwd(q, k, v, dout, lse), 20)
    g_lib = device_ms(torch, sdpa_fwd_bwd, 20) - device_ms(
        torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20)
    rows["flash_attention_bwd"]["qwen_gqa"] = dict(ms=g_ms, library_ms=g_lib,
                                                   bound_ms=g_bound[0])
    log(f"phase 3: flash_attention_bwd qwen GQA B=4 H={lm_h} KVH={lm_kvh} "
        f"S=T=256 D={lm_d} bf16 causal: kernel {g_ms:.6f} ms, library (SDPA "
        f"backward) {g_lib:.6f} ms; bound {g_bound[0]:.6f} ms ({g_bound[1]}); "
        f"kernel {g_ms / g_bound[0]:.1f}x its bound, {g_ms / g_lib:.2f}x "
        f"SDPA's backward")
    # ... and at deepseek's MLA (Dk 192, Dv 128, MLA's scale),
    # paligemma's heads (8 over one kv head of 256) and hubert's (16 of 80,
    # bidirectional): each one's training shape (phases 11e, 11g, 11f) and
    # the first two's prefill shapes (phases 9, 10b), each beside its
    # bound, the plain version, SDPA's forward and SDPA's forward +
    # backward, and its device time by kernel
    for label, dims, scale, causal in (
            ("MLA train", mla_train_dims, mla_scale, True),
            ("MLA prefill", mla_dims, mla_scale, True),
            ("paligemma train", pali_train_dims, pali_d ** -0.5, True),
            ("paligemma prefill", pali_dims, pali_d ** -0.5, True),
            ("hubert train", hu_train_dims, hu_cfg.head_dim ** -0.5, False)):
        b_, h_, kvh_, s_, _, dk_, dv_ = dims
        q, k, v = (x.contiguous() for x in qkv(*dims, bf16))
        dout = torch.randn(q.shape[:3] + (dv_,), device=dev).to(bf16)
        _, lse = _card_forward(q, k, v, causal, scale, 0, s_, s_,
                               with_lse=True)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

        def pair_sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                                 scale=scale,
                                                 enable_gqa=kvh_ < h_)
            return torch.autograd.grad(out, (qg, kg, vg), dout)

        plain_grads = flash_attention_bwd_plain(
            q.float(), k.float(), v.float(), dout.float(), causal=causal)
        check(all(err(a, b) <= 1e-2 * float(b.abs().max())
                  for a, b in zip(pair_sdpa_fwd_bwd(), plain_grads)),
              f"SDPA's gradient differs from the plain version's at {label}")
        del plain_grads
        m_bound = fa_bwd_bound(b_, h_, kvh_, s_, s_, dk_, dv_, causal)
        m_ms = device_ms(torch, lambda: flash_attention_bwd(
            q, k, v, dout, lse, causal=causal), 20)
        m_plain = device_ms(torch, lambda: flash_attention_bwd_plain(
            q, k, v, dout, causal=causal), 1)
        m_fb = device_ms(torch, pair_sdpa_fwd_bwd, 20)
        m_f = device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale, enable_gqa=kvh_ < h_), 20)
        m_fwd = device_ms(torch, lambda: _card_forward(
            q, k, v, causal, scale, 0, s_, s_, with_lse=True), 20)
        _, _, per_kernel = device_profile(torch, lambda: [
            flash_attention_bwd(q, k, v, dout, lse, causal=causal)
            for _ in range(20)])
        # the route: bf16 on the tensor cores both ways, f32 on the CUDA
        # cores; one device kernel a forward, two a backward (and, bf16
        # with a GQA group, the kernel that adds the heads' dK/dV partials).
        # A window runs ROUTE_CALLS forward-then-backward calls: its trace
        # must name exactly these kernels, none more often than once a
        # call (a trace can drop a kernel of ours, profile_ours)
        pair = f"{dk_}, {dv_}"
        want = {"bfloat16": sorted([f"flash_wgmma_kernel<{pair}>",
                                    f"flash_dq_wgmma_kernel<{pair}>",
                                    f"flash_dkdv_wgmma_kernel<{pair}>"]
                                   + [f"flash_dkdv_sum_kernel<{pair}>"]
                                   * (kvh_ < h_)),
                "float32": sorted([f"flash_kernel<float, {dv_}>",
                                   f"flash_dq_kernel<{pair}>",
                                   f"flash_dkdv_kernel<{pair}>"])}
        routes = {}
        for dtype in (bf16, torch.float32):
            x3 = [x.to(dtype) for x in (q, k, v, dout)]
            _, lse3 = _card_forward(*x3[:3], causal, scale, 0, s_, s_,
                                    with_lse=True)
            *_, counts = profile_ours(torch, lambda: [(
                _card_forward(*x3[:3], causal, scale, 0, s_, s_,
                              with_lse=True),
                flash_attention_bwd(*x3, lse3, causal=causal))
                for _ in range(ROUTE_CALLS)],
                ("flash",), ROUTE_CALLS * len(want[str(dtype)[6:]]),
                f"phase 3: {label} {dtype}")
            routes[str(dtype)[6:]] = sorted(
                kernel_name(n) + n[n.index("<"):n.index(">") + 1]
                for n in counts if "flash" in n)
            check(all(c <= ROUTE_CALLS for n, c in counts.items()
                      if "flash" in n),
                  f"flash_attention {label} {dtype}: device launches of "
                  f"{ROUTE_CALLS} calls {counts}")
        check(routes == want, f"flash_attention {label}: the kernels that "
              f"ran {routes}, expected {want}")
        rows["flash_attention_bwd"][label] = dict(
            ms=m_ms, plain_ms=m_plain, library_ms=m_fb - m_f,
            bound_ms=m_bound[0])
        passes = ("one pass: dK and dV together" if dk_ + dv_ <= 256 else
                  "two passes: dV, then dK" if dk_ <= 192 else
                  "three passes: dV, then dK's columns in two halves")
        log(f"phase 3: flash_attention_bwd {label} B={b_} H={h_} KVH={kvh_} "
            f"S=T={s_} Dk={dk_} Dv={dv_} bf16 "
            f"{'causal' if causal else 'non-causal'}: kernel {m_ms:.6f} ms "
            f"(dQ, then dK/dV in {passes}), plain "
            f"{m_plain:.6f} ms, library (SDPA backward: forward + backward "
            f"{m_fb:.6f} less forward {m_f:.6f}) {m_fb - m_f:.6f} ms; bound "
            f"{m_bound[0]:.6f} ms ({m_bound[1]}); kernel "
            f"{m_ms / m_bound[0]:.1f}x its bound, {m_ms / (m_fb - m_f):.2f}x "
            f"SDPA's backward; the forward kernel keeping the log-sum-exp "
            f"{m_fwd:.6f} ms (SDPA's forward {m_f:.6f}); kernels of a forward "
            f"and a backward by dtype {routes}; device us a call by "
            f"kernel (torch.profiler over 20 calls): " + ", ".join(
                f"{kernel_name(k_)} {v_ / 20:.2f}"
                for k_, v_ in sorted(per_kernel.items(), key=lambda kv: -kv[1])))
        del q, k, v, dout, lse, qg, kg, vg

    # decode attention as the model's decode step calls it: qwen's step
    # (B = 4, H = 16 over 2 kv heads of 128, a bf16 cache of 512 keys), each
    # row at its own length (the engine's positions after a 256-token
    # prompt: 257 .. 272 keys), q in bf16, out bf16.  Bound: the keys and
    # values each row attends to read once, q read and out written once,
    # against 2 (Dk + Dv) flops per head and key.  Plain: the step's
    # products (decode_attention_masked_ref); library: SDPA with one query
    # and a boolean mask of each row's keys.
    q = normal(LM_BATCH, lm_h, lm_d, dtype=bf16)
    k = normal(LM_BATCH, lm_kvh, LM_MAX_LEN, lm_d, dtype=bf16)
    v = normal(LM_BATCH, lm_kvh, LM_MAX_LEN, lm_d, dtype=bf16)
    lens = torch.tensor([257, 262, 267, 272][:LM_BATCH], device=dev)
    n_keys = int(lens.sum())
    keep_mask = (torch.arange(LM_MAX_LEN, device=dev)[None] < lens[:, None]
                 )[:, None, None, :]

    def sdpa_lengths():
        return F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=keep_mask, enable_gqa=True)[:, :, 0]

    check(err(sdpa_lengths(), decode_attention_masked_ref(q, k, v, lens))
          <= 5e-2, "SDPA with a mask differs from the masked decode attention")
    dl_bound = bound(2.0 * (2 * n_keys * lm_kvh * lm_d
                            + 2 * LM_BATCH * lm_h * lm_d),
                     2.0 * n_keys * lm_h * 2 * lm_d, PEAK_BF16_FLOPS)
    rows["decode_attention"] = r = dict(
        ms=device_ms(torch, lambda: decode_attention(q, k, v, lengths=lens),
                     100),
        plain_ms=device_ms(torch, lambda: decode_attention_masked_ref(
            q, k, v, lens), 10),
        library_ms=device_ms(torch, sdpa_lengths, 100),
        bound_ms=dl_bound[0], bound_by=dl_bound[1])
    log(f"phase 3: decode_attention with lengths, qwen's step B={LM_BATCH} "
        f"H={lm_h} KVH={lm_kvh} T={LM_MAX_LEN} D={lm_d} bf16, lengths "
        f"{lens.tolist()} (the row the kernels line reports): device time per "
        f"call: kernel {fmt(r['ms'])}, plain (the step's products) "
        f"{fmt(r['plain_ms'])}, library (SDPA, one query, a mask) "
        f"{fmt(r['library_ms'])}; bound {r['bound_ms']:.6f} ms "
        f"({r['bound_by']}); kernel {r['ms'] / r['bound_ms']:.1f}x its bound")

    # the norm kernel at the shapes the paths give it: qwen's decode step
    # (4 rows of 2048, RMS, bf16: the row the kernels line reports) and its
    # prefill (256 rows), stablelm's training forward (1024 rows of 2048,
    # LayerNorm), rwkv's step group norm (4 rows of 40 groups of 64) and
    # deepseek's latent norm (4 rows of 512), that last one also on the
    # latent slice the model passes (kv_a[..., :512] of 4 x 576, read in
    # place; the library call reads the same view).  Bound: x read and y written
    # once, the f32 scale (and bias) read once, against ~6 flops an element
    # at the f32 peak.  Plain: the model's norm in PyTorch ops (its plain
    # version); library: F.rms_norm / F.layer_norm (scale and bias in x's
    # dtype, as those calls take them; F.group_norm over groups of 64
    # consecutive channels for the group norm).
    norm_rows = {}
    for label, rows_, d_, form in (
            ("qwen step RMS", LM_BATCH, 2048, "rms"),
            ("qwen prefill RMS", 256, 2048, "rms"),
            ("stablelm train LayerNorm", TRAIN_BATCH * TRAIN_SEQ, 2048, "layer"),
            ("rwkv step groups of 64", RWKV_BATCH, 2560, "group"),
            ("deepseek latent RMS", LM_BATCH, 512, "rms"),
            ("deepseek latent slice RMS", LM_BATCH, 512, "slice")):
        x_ = normal(rows_, 576 if form == "slice" else d_, dtype=bf16)[:, :d_]
        sc_, bi_ = normal(d_), normal(d_)
        if form in ("rms", "slice"):
            fn = lambda: rms_norm(x_, sc_, 1e-6)  # noqa: E731
            pl = lambda: rms_norm_ref(x_, sc_, 1e-6)  # noqa: E731
            lib = lambda: F.rms_norm(x_, (d_,), sc_.to(bf16), 1e-6)  # noqa: E731
        elif form == "layer":
            fn = lambda: layer_norm(x_, sc_, bi_, 1e-5)  # noqa: E731
            pl = lambda: layer_norm_ref(x_, sc_, bi_, 1e-5)  # noqa: E731
            lib = lambda: F.layer_norm(x_, (d_,), sc_.to(bf16), bi_.to(bf16),  # noqa: E731
                                       1e-5)
        else:
            fn = lambda: group_norm(x_, sc_, None, 64, 1e-5)  # noqa: E731
            pl = lambda: group_norm_ref(x_, sc_, None, 64, 1e-5)  # noqa: E731
            lib = lambda: F.group_norm(x_, d_ // 64, sc_.to(bf16), None,  # noqa: E731
                                       1e-5)
        nb = 2.0 * 2 * rows_ * d_ + 4.0 * d_ * (2 if form == "layer" else 1)
        n_bound = bound(nb, 6.0 * rows_ * d_)
        norm_rows[label] = r = dict(
            ms=device_ms(torch, fn, 100), plain_ms=device_ms(torch, pl, 20),
            library_ms=device_ms(torch, lib, 100), bound_ms=n_bound[0],
            bound_by=n_bound[1])
        log(f"phase 3: norm {label} ({rows_} x {d_} bf16): device time per "
            f"call: kernel {fmt(r['ms'])}, plain {fmt(r['plain_ms'])}, library "
            f"{fmt(r['library_ms'])}; bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']}); kernel {r['ms'] / r['bound_ms']:.1f}x its "
            f"bound, {r['ms'] / r['library_ms']:.2f}x the library call")
    rows["norm"] = norm_rows["qwen step RMS"]

    # rwkv6_scan at rwkv6-3b's prefill shape (state0 absent, as the prefill
    # passes it) and one decode step (T = 1 from a state), with B = 1,
    # T = 4096 logged beside them.  Bound: r, k, v (bf16) and w (f32) read
    # once, u and any state0 read once, y (bf16) and the f32 state written
    # once, against 5 D^2 f32 flops per step and head (rwkv6_scan's counts).
    # No single PyTorch call computes the scan: library none.
    def rwkv_bound(b_, t_, with_state):
        n_in = b_ * rw_h * t_ * rw_d
        state = 4.0 * b_ * rw_h * rw_d * rw_d
        nbytes = (n_in * (3 * 2 + 4 + 2) + 4.0 * rw_h * rw_d + state
                  + (state if with_state else 0.0))
        return bound(nbytes, 5.0 * n_in * rw_d)

    rw_rows = {}
    for label, b_, t_, with_state, per_graph in (
            ("prefill", RWKV_BATCH, RWKV_PROMPT, False, 50),
            ("decode step", RWKV_BATCH, 1, True, 100),
            ("long", 1, 4096, False, 3)):
        ins = rwkv_inputs(b_, rw_h, t_, rw_d, bf16)
        s0 = normal(b_, rw_h, rw_d, rw_d) if with_state else None
        b_ms, b_by = rwkv_bound(b_, t_, with_state)
        rw_rows[label] = dict(
            ms=device_ms(torch, lambda: rwkv6_scan(*ins, s0), per_graph),
            plain_ms=device_ms(torch, lambda: rwkv6_scan_plain(*ins, s0),
                               max(1, per_graph // 10)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by)
        r = rw_rows[label]
        log(f"phase 3: rwkv6_scan {label} B={b_} H={rw_h} T={t_} D={rw_d} "
            f"(r/k/v bf16, w f32{', from a state' if with_state else ''}): "
            f"device time per call: kernel {fmt(r['ms'])}, plain "
            f"{fmt(r['plain_ms'])}, library none; bound {b_ms:.6f} ms ({b_by}); "
            f"kernel {r['ms'] / b_ms:.1f}x its bound")
    rows["rwkv6_scan"] = rw_rows["prefill"]

    # decode_attention at qwen's decode shape (the cache of the LM path's
    # max_len), T = 32768 logged beside it; the library call is SDPA with
    # one query and enable_gqa.  Bound: q, k, v read once and out written
    # once in bf16, against 2 (Dk + Dv) flops per (head, key) at the bf16 peak.
    def sdpa_one(q, k, v):
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              enable_gqa=True)[:, :, 0]

    da_rows = {}
    for label, t_, per_graph in (("decode", LM_MAX_LEN, 100), ("long", 32768, 10)):
        q = normal(LM_BATCH, lm_h, lm_d, dtype=bf16)
        k, v = (normal(LM_BATCH, lm_kvh, t_, lm_d, dtype=bf16) for _ in range(2))
        check(err(sdpa_one(q, k, v), decode_attention_ref(q, k, v)) <= 5e-2,
              f"SDPA differs from the plain decode attention at T={t_}")
        b_ms, b_by = bound(
            2.0 * (2 * LM_BATCH * lm_h * lm_d + 2 * LM_BATCH * lm_kvh * t_ * lm_d),
            2.0 * LM_BATCH * lm_h * t_ * 2 * lm_d, PEAK_BF16_FLOPS)
        da_rows[label] = dict(
            ms=device_ms(torch, lambda: decode_attention(q, k, v), per_graph),
            plain_ms=device_ms(torch, lambda: decode_attention_ref(q, k, v),
                               max(1, per_graph // 10)),
            library_ms=device_ms(torch, lambda: sdpa_one(q, k, v), per_graph),
            bound_ms=b_ms, bound_by=b_by)
        r = da_rows[label]
        if label == "long":
            # the rule this plan replaced: one sequence alone aimed at the
            # card (PLAN_BATCH = 1), whose cut is as B-free but finer
            da_module.PLAN_BATCH, kept = 1, da_module.PLAN_BATCH
            fine = plan_decode_splits(lm_kvh, t_, n_sms)
            fine_ms = device_ms(torch, lambda: decode_attention(q, k, v), per_graph)
            da_module.PLAN_BATCH = kept
            log(f"phase 3: decode_attention long, the plan for one sequence "
                f"alone ({fine[0]} splits of {fine[1]} keys, "
                f"{fine[0] * LM_BATCH * lm_kvh} blocks): kernel {fmt(fine_ms)} "
                f"against {fmt(r['ms'])} with the plan batch of "
                f"{da_module.PLAN_BATCH}")
        n_split, kps = plan_decode_splits(lm_kvh, t_, n_sms)
        log(f"phase 3: decode_attention {label} B={LM_BATCH} H={lm_h} "
            f"KVH={lm_kvh} T={t_} D={lm_d} bf16 ({n_split} splits of {kps} "
            f"keys, {n_split * LM_BATCH * lm_kvh} blocks): device time per call: kernel "
            f"{fmt(r['ms'])}, plain {fmt(r['plain_ms'])}, library (SDPA, one "
            f"query) {fmt(r['library_ms'])}; bound {b_ms:.6f} ms ({b_by}); "
            f"kernel {r['ms'] / b_ms:.1f}x its bound ({b_ms / r['ms']:.3f} of "
            f"it), {r['ms'] / r['library_ms']:.2f}x SDPA")
    # (the kernels line reports the model's step with lengths, timed above)

    # mamba_scan's kernel (selective_scan: the scan without the D x skip,
    # which the op adds in plain PyTorch as the JAX op does) at jamba's
    # width with the dtypes the jamba block passes under bf16: B = 1,
    # T = 256 (the decode engine's prefill in phase 10a: the row reported),
    # B = 4, T = 256 (the row earlier runs reported), phase 4c's B = 2,
    # T = 128 and one long sequence, B = 1, T = 4096, beside it.  Bound: x (bf16), delta (f32),
    # a, b, c (f32) read once, y (bf16) and the f32 state written once,
    # against 6 N flops per step and channel (mamba_scan's counts).  The
    # special-function unit's floor is logged beside it: one exponential
    # per step, channel and state at 16 a clock per SM (CUDA C++
    # Programming Guide, compute capability 9.0) and the max SM clock.
    # Library none.
    mb_rows = {}
    for b_, t_, per_graph in ((1, 256, 40), (4, 256, 20), (2, 128, 80),
                              (1, 4096, 5)):
        ins = ssm_inputs(b_, t_, mb_dm, mb_n, bf16)
        elems = b_ * t_ * mb_dm
        mb_bound = bound(elems * (2 + 4 + 2) + 4.0 * (
            mb_dm * mb_n + 2 * b_ * t_ * mb_n + b_ * mb_dm * mb_n),
            6.0 * elems * mb_n)
        sfu_ms = elems * mb_n / (SFU_PER_CLK_PER_SM * n_sms * max_sm_mhz * 1e6) * 1e3
        mb_rows[b_, t_] = r = dict(
            ms=device_ms(torch, lambda: selective_scan(*ins), per_graph),
            plain_ms=device_ms(torch, lambda: mamba_scan_plain(*ins), 1),
            library_ms=None, bound_ms=mb_bound[0], bound_by=mb_bound[1])
        plan = plan_mamba(b_, t_, mb_dm, mb_n, n_sms)
        log(f"phase 3: mamba_scan B={b_} T={t_} Dm={mb_dm} N={mb_n} (x bf16, "
            f"the rest f32; {plan.lanes} lanes a channel, {plan.blocks} blocks, "
            f"{plan.warps_per_sm:.2f} warps an SM): device time per call: "
            f"kernel {fmt(r['ms'])}, plain {fmt(r['plain_ms'])}, library none; "
            f"bound {mb_bound[0]:.6f} ms ({mb_bound[1]}), SFU floor "
            f"{sfu_ms:.6f} ms; kernel {r['ms'] / mb_bound[0]:.2f}x its bound, "
            f"{r['ms'] / sfu_ms:.2f}x the SFU floor")
    rows["mamba_scan"] = mb_rows[1, 256]

    # the scans' backward kernels at the training shapes (rwkv6-3b: B = 8,
    # H = 40, T = 128, D = 64, r/k/v/dy bf16 and w f32; jamba: B = 8,
    # T = 128, Dm = 16384, N = 16, x/dy bf16, delta f32), each beside its
    # bound and its plain version (autograd through the plain forward); no
    # PyTorch call computes either gradient: library none.  Bounds: rwkv
    # reads r, k, v, dy (bf16), w (f32) and u once and writes dr, dk, dv
    # (bf16), dw (f32) and du once, against 6 FMAs (12 f32 flops) a state
    # entry a step (the S and G recurrences and the products of dr, dk, dv
    # and dw); mamba reads x, dy (bf16), delta (f32), a, b and c once and
    # writes dx (bf16), ddelta (f32), da, db and dc once, against 18 f32
    # flops a step, channel and state (the h and dh recurrences and the
    # terms of dx, ddelta, da, db and dc), with the special-function unit's
    # floor (one exponential a step, channel and state) logged beside it.
    r_, k_, v_ = (normal(TRAIN_BATCH, rw_h, TRAIN_SEQ, rw_d, dtype=bf16,
                         sc=0.5) for _ in range(3))
    w_ = torch.exp(-torch.exp(normal(TRAIN_BATCH, rw_h, TRAIN_SEQ, rw_d,
                                     sc=0.5) - 1.0))
    u_ = normal(rw_h, rw_d, sc=0.5)
    dy_ = normal(TRAIN_BATCH, rw_h, TRAIN_SEQ, rw_d, dtype=bf16)
    n_in = TRAIN_BATCH * rw_h * TRAIN_SEQ * rw_d
    b_ms, b_by = bound(n_in * (4 * 2 + 4 + 3 * 2 + 4) + 8.0 * rw_h * rw_d,
                       12.0 * n_in * rw_d)
    rows["rwkv6_scan_bwd"] = r = dict(
        ms=device_ms(torch, lambda: rwkv6_scan_bwd(r_, k_, v_, w_, u_, dy_), 20),
        plain_ms=device_ms(torch, lambda: rwkv6_scan_bwd_plain(
            r_, k_, v_, w_, u_, dy_), 1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    fwd_ms = device_ms(torch, lambda: rwkv6_scan(r_, k_, v_, w_, u_), 20)
    # the same values in the model's layout: transposed (B, H, T, D) views
    views = [z.transpose(1, 2).contiguous().transpose(1, 2)
             for z in (r_, k_, v_, w_, dy_)]
    view_ms = device_ms(torch, lambda: rwkv6_scan_bwd(
        views[0], views[1], views[2], views[3], u_, views[4]), 20)
    log(f"phase 3: rwkv6_scan_bwd rwkv6-3b training B={TRAIN_BATCH} H={rw_h} "
        f"T={TRAIN_SEQ} D={rw_d} (r/k/v/dy bf16, w f32): device time per "
        f"call: kernel {fmt(r['ms'])} (the backward and du's sum over B; on "
        f"the model's transposed views {view_ms:.6f}), "
        f"plain {fmt(r['plain_ms'])} (autograd through the plain forward), "
        f"library none; bound {b_ms:.6f} ms ({b_by}); kernel "
        f"{r['ms'] / b_ms:.1f}x its bound; the forward kernel at this shape "
        f"{fwd_ms:.6f} ms")
    for src, kname, regs, spill_st, spill_ld, stack in ptxas_job.result():
        log(f"phase 3: ptxas_report {src}: {regs} registers, spill stores "
            f"{spill_st} B, spill loads {spill_ld} B, stack {stack} B: {kname}")
    ptxas_pool.shutdown()
    ins = ssm_inputs(TRAIN_BATCH, TRAIN_SEQ, mb_dm, mb_n, bf16)
    dy_ = normal(TRAIN_BATCH, TRAIN_SEQ, mb_dm, dtype=bf16)
    elems = TRAIN_BATCH * TRAIN_SEQ * mb_dm
    b_ms, b_by = bound(elems * (2 + 2 + 4 + 2 + 4) + 8.0 * (
        mb_dm * mb_n + 2 * TRAIN_BATCH * TRAIN_SEQ * mb_n),
        18.0 * elems * mb_n)
    sfu_ms = elems * mb_n / (SFU_PER_CLK_PER_SM * n_sms * max_sm_mhz * 1e6) * 1e3
    rows["mamba_scan_bwd"] = r = dict(
        ms=device_ms(torch, lambda: mamba_scan_bwd(*ins, dy_), 10),
        plain_ms=device_ms(torch, lambda: mamba_scan_bwd_plain(*ins, dy_), 1,
                           replays=3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    fwd_ms = device_ms(torch, lambda: selective_scan(*ins), 20)
    log(f"phase 3: mamba_scan_bwd jamba training B={TRAIN_BATCH} T={TRAIN_SEQ} "
        f"Dm={mb_dm} N={mb_n} (x/dy bf16, delta f32): device time per call: "
        f"kernel {fmt(r['ms'])} (the backward and the sums of da, db and dc), "
        f"plain {fmt(r['plain_ms'])} (autograd through the plain forward), "
        f"library none; bound {b_ms:.6f} ms ({b_by}), SFU floor "
        f"{sfu_ms:.6f} ms (the design's two exponentials a step, channel and "
        f"state: {2 * sfu_ms:.6f}); kernel {r['ms'] / b_ms:.2f}x its bound, "
        f"{r['ms'] / sfu_ms:.2f}x the SFU floor; the forward kernel at this "
        f"shape {fwd_ms:.6f} ms")

    # -- 4a. the TinyBio main path --------------------------------------------
    phase_done("4a")
    runs = {}
    torch.cuda.synchronize()
    common.reset_launches()
    walls = {}
    for cfg in configs:
        for mode in ("graph", "eager"):
            t0 = time.perf_counter()
            runs[cfg.name, mode] = tinybio.run_tinybio(cfg, 0, mode, device="cuda")
            torch.cuda.synchronize()
            walls[cfg.name, mode] = time.perf_counter() - t0
    wall = sum(walls.values())
    launches = dict(common.LAUNCHES)
    expected = len(configs) * (1 + 2)
    for name in KERNELS:
        want = expected if name in TINYBIO_KERNELS else 0
        check(launches[name] == want,
              f"TinyBio main path launched {name} {launches[name]} times, "
              f"expected {want}")
    log(f"phase 4: TinyBio main path (3 configs x graph + eager) in {wall:.3f} s "
        f"(per run: {', '.join(f'{c} {m} {t:.3f} s' for (c, m), t in walls.items())}), "
        f"launches {launches}")
    for cfg in configs:
        dg, rg = runs[cfg.name, "graph"]
        de, re_ = runs[cfg.name, "eager"]
        check(dg.is_cuda and dg.shape == (128,) and bool(torch.isfinite(dg).all()),
              "decisions are not 128 finite values on the card")
        check(torch.equal(dg, de), f"{cfg.name}: graph and eager decisions differ")
        for mode, (dec, rep) in (("graph", (dg, rg)), ("eager", (de, re_))):
            cd, cr = tinybio.run_tinybio(cfg, 0, mode, device="cpu")
            check(dataclasses.asdict(rep) == dataclasses.asdict(cr),
                  f"{cfg.name} {mode}: report differs from the CPU run's")
            check(torch.allclose(dec.cpu(), cd, rtol=0, atol=1e-6),
                  f"{cfg.name} {mode}: decisions differ from the CPU run's")
        log(f"phase 4: {cfg.name}: report == CPU report, fused speed-up "
            f"{rg.fused_speedup!r}")

    # each stage on the card, fed the CPU run's previous-stage output
    cstages, cinputs = tinybio.tinybio_stages(EGPU_16T, 0, "cpu")
    cur = tuple(cinputs)
    tol = {"fir": dict(rtol=0, atol=1e-6), "delineate_keep": None,
           "fft_features": dict(rtol=1e-4, atol=5e-5),
           "svm": dict(rtol=0, atol=1e-6)}
    for cs, gs in zip(cstages, stages):
        want = cs.kernel.executor(*cur, *cs.consts, **cs.params)
        want = want if isinstance(want, tuple) else (want,)
        got = gs.kernel.executor(*[a.to(dev) for a in cur], *gs.consts,
                                 **gs.params)
        got = got if isinstance(got, tuple) else (got,)
        for a, bb in zip(got, want):
            t = tol[gs.kernel.name]
            ok = (torch.equal(a.cpu(), bb) if t is None or not bb.is_floating_point()
                  else torch.allclose(a.cpu(), bb, **t))
            check(ok, f"stage {gs.kernel.name} differs from the CPU run's")
        cur = want
    yc = cstages[0].kernel.executor(cinputs[0], cstages[0].consts[0])
    flips = int((delineate_ref(yc, 0) != flags.cpu()).sum())
    check(flips <= 8, f"{flips} flags differ end to end from the CPU run's")
    log(f"phase 4: every stage matches the CPU run's; end-to-end flag flips {flips}")

    # where one warm graph offload's time goes: device time by kernel name
    # (torch.profiler) against the host's wall clock
    tinybio.run_tinybio(EGPU_16T, 0, "graph", device="cuda")
    torch.cuda.synchronize()
    log("phase 4: " + profile_line(
        "one warm 16T TinyBio graph offload", *device_profile(
            torch, lambda: tinybio.run_tinybio(EGPU_16T, 0, "graph",
                                               device="cuda"))))

    # -- 4b. the GeMM main path (paper Fig 3, the quickstart's offload) -------
    phase_done("4b")
    qa = np.random.default_rng(0).integers(-64, 64, (2, 256, 256)).astype(np.int32)
    qa, qb = qa[0], qa[1]
    cp = {"m": 256, "n": 256, "k": 256}

    def gemm_offload(cfg, mode, device):
        stage = Stage(Program.build(cfg).create_kernel("gemm"), counts_params=cp)
        return APU(cfg, device=device).offload([stage], (qa, qb), mode=mode)

    gruns, gwalls = {}, {}
    torch.cuda.synchronize()
    common.reset_launches()
    for cfg in configs:
        for mode in ("graph", "eager"):
            t0 = time.perf_counter()
            gruns[cfg.name, mode] = gemm_offload(cfg, mode, "cuda")
            torch.cuda.synchronize()
            gwalls[cfg.name, mode] = time.perf_counter() - t0
    gemm_launches = dict(common.LAUNCHES)
    for name in KERNELS:
        want = expected if name in GEMM_KERNELS else 0
        check(gemm_launches[name] == want,
              f"GeMM main path launched {name} {gemm_launches[name]} times, "
              f"expected {want}")
    launches.update({name: gemm_launches[name] for name in GEMM_KERNELS})
    log(f"phase 4: GeMM main path (3 configs x graph + eager, 256^3 int32) in "
        f"{sum(gwalls.values()):.3f} s (per run: "
        f"{', '.join(f'{c} {m} {t:.3f} s' for (c, m), t in gwalls.items())}), "
        f"launches {gemm_launches}")
    exact = qa.astype(np.int64) @ qb.astype(np.int64)
    for (cfg_name, mode), ((out,), rep) in gruns.items():
        check(out.data.is_cuda and out.data.dtype == torch.int32
              and np.array_equal(out.data.cpu().numpy(), exact),
              f"GeMM offload {cfg_name} {mode}: output is not A @ B")
        cfg = next(c for c in configs if c.name == cfg_name)
        _, crep = gemm_offload(cfg, mode, "cpu")
        check(dataclasses.asdict(rep) == dataclasses.asdict(crep),
              f"GeMM offload {cfg_name} {mode}: report differs from the CPU run's")
    rep16 = gruns[EGPU_16T.name, "graph"][1].stages[0]
    log(f"phase 4: GeMM offloads exact, reports == CPU reports; 16T modeled "
        f"speed-up {rep16.speedup!r}, energy reduction {rep16.energy_reduction!r}")
    gemm_offload(EGPU_16T, "graph", "cuda")
    torch.cuda.synchronize()
    g_wall, g_busy, g_kernels = device_profile(
        torch, lambda: gemm_offload(EGPU_16T, "graph", "cuda"))
    log("phase 4: " + profile_line("one warm 16T GeMM graph offload",
                                   g_wall, g_busy, g_kernels))
    # no library product and no plain version on the path: the only
    # device-side kernel is the hand-written one (besides the copies)
    library = [k for k in g_kernels
               if any(t in k.lower() for t in ("sgemm", "xmma", "cutlass",
                                               "cublas", "gemv", "elementwise",
                                               "reduce"))]
    check(not library, f"GeMM offload ran library or plain kernels: {library}")
    check(any("gemm_kernel" in k for k in g_kernels),
          "GeMM offload's profile shows no gemm_kernel")

    # the Fig-3, transfer and multi-queue benches on the card, their
    # modeled numbers equal to the CPU run's
    check(bench_gemm_overhead.run("cuda") == bench_gemm_overhead.run("cpu"),
          "bench_gemm_overhead rows differ between the card and the CPU")
    for bench in (bench_transfer, bench_multiqueue):
        on_card, on_cpu = bench.run("cuda"), bench.run("cpu")
        for key in on_cpu:
            if key not in ("device", "fused_launch_wall_us"):
                check(on_card[key] == on_cpu[key],
                      f"{bench.__name__} {key}: {on_card[key]} on the card, "
                      f"{on_cpu[key]} on the CPU")
    ctx = Context(Device(EGPU_16T), "cuda")
    for graph, per_launch in (
            (bench_transfer._capture_explicit(ctx), 4),
            (bench_transfer._capture_naive(ctx), 4),
            (bench_multiqueue._capture(ctx, True), 5)):   # pre + 4 branches
        scratch = CommandQueue(ctx)
        torch.cuda.synchronize()
        before = dict(common.LAUNCHES)
        graph.launch(queue=scratch)
        torch.cuda.synchronize()
        moved = {k: common.LAUNCHES[k] - before[k] for k in before}
        check(moved == {k: per_launch if k == "gemm" else 0 for k in before},
              f"a DAG bench graph launch moved the counters by {moved}")
    log("phase 4: bench_gemm_overhead rows, bench_transfer and "
        "bench_multiqueue modeled numbers equal the CPU run's; gemm launches "
        "4 per transfer-graph launch, 5 per multi-queue graph launch")

    # -- 4c. the registry's decode_attention and mamba_scan families -------
    phase_done("4c")
    # Program.build(cfg).create_kernel(family) for 4T, 8T and 16T, each
    # enqueued once through a CommandQueue and offloaded through APU.offload
    # in graph and eager mode, with the launch counters reset just before
    # and read just after: each family launched once per queue enqueue and
    # graph offload, twice per eager one (its e-GPU and host contexts), and
    # no other kernel.  Both kernels are deterministic, so every result
    # equals the op's bit for bit; every modeled report equals the CPU run's
    # (the same inputs, copied to the CPU) float for float.
    reg_inputs = {
        "decode_attention": (
            (normal(LM_BATCH, lm_h, lm_d, dtype=bf16),
             normal(LM_BATCH, lm_kvh, LM_MAX_LEN, lm_d, dtype=bf16),
             normal(LM_BATCH, lm_kvh, LM_MAX_LEN, lm_d, dtype=bf16)),
            {"b": LM_BATCH, "h": lm_h, "t": LM_MAX_LEN, "dk": lm_d, "dv": lm_d,
             "itemsize": 2}),
        "mamba_scan": (
            ssm_inputs(2, 128, mb_dm, mb_n, bf16) + (normal(mb_dm),),
            {"bsz": 2, "t": 128, "dm": mb_dm, "n": mb_n}),
    }
    reg_ops = {"decode_attention": decode_attention, "mamba_scan": mamba_scan}
    reg_runs = {}
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    for family, (ins, cp) in reg_inputs.items():
        for cfg in configs:
            kern = Program.build(cfg).create_kernel(family)
            queue = CommandQueue(Context(Device(cfg), "cuda"))
            kern.set_args(*ins)
            reg_runs[family, cfg.name, "queue"] = (
                queue.enqueue_kernel(kern, counts_params=cp).wait(), None)
            for mode in ("graph", "eager"):
                reg_runs[family, cfg.name, mode] = APU(cfg, device="cuda").offload(
                    [Stage(kern, counts_params=cp)], ins, mode=mode)
    torch.cuda.synchronize()
    reg_wall = time.perf_counter() - t0
    reg_launches = dict(common.LAUNCHES)
    for name in KERNELS:
        want = len(configs) * (1 + 1 + 2) if name in REGISTRY_KERNELS else 0
        check(reg_launches[name] == want,
              f"the registry phase launched {name} {reg_launches[name]} times, "
              f"expected {want}")
    launches.update({name: reg_launches[name] for name in REGISTRY_KERNELS})
    for family, (ins, cp) in reg_inputs.items():
        direct = reg_ops[family](*ins)
        direct = direct if isinstance(direct, tuple) else (direct,)
        cpu_ins = tuple(t.cpu() for t in ins)
        for cfg in configs:
            for mode in ("queue", "graph", "eager"):
                outs, rep = reg_runs[family, cfg.name, mode]
                check(len(outs) == len(direct) and all(
                    o.data.is_cuda and torch.equal(o.data, d_)
                    for o, d_ in zip(outs, direct)),
                    f"{family} {cfg.name} {mode}: result differs from the op's")
                if rep is None:
                    continue
                cpu_kern = Program.build(cfg).create_kernel(family)
                _, crep = APU(cfg, device="cpu").offload(
                    [Stage(cpu_kern, counts_params=cp)], cpu_ins, mode=mode)
                check(dataclasses.asdict(rep) == dataclasses.asdict(crep),
                      f"{family} {cfg.name} {mode}: report differs from the CPU run's")
        rep16 = reg_runs[family, EGPU_16T.name, "graph"][1].stages[0]
        log(f"phase 4c: registry family {family} (4T/8T/16T; queue, graph and "
            f"eager): results equal the op's, reports == CPU reports; 16T "
            f"modeled speed-up {rep16.speedup!r}")
    log(f"phase 4c: registry phase in {reg_wall:.3f} s, launches {reg_launches}")

    # -- 4d. the queue options on the card, with the registry's kernels --------
    phase_done("4d")
    # The gemm family (256^3 int32) and the four TinyBio families at the
    # paper's size, on 16T, through three queues: the default one, an
    # unprofiled blocking one and a profiled one with a window of 2 events,
    # the latter two with blocking transfers.  Each family: a write of its
    # first input into a fresh buffer, the kernel, a read of its output.
    # The launch counters are reset just before and read just after.
    fam_x = inputs[0]
    fam_in = {
        "gemm": ((torch.from_numpy(qa).to(dev), torch.from_numpy(qb).to(dev)),
                 {}, {"m": 256, "n": 256, "k": 256}),
        "fir": ((fam_x, h), {}, {"n": fam_x.numel(), "taps": h.numel()}),
        "delineate": ((fir(fam_x, h),), {}, {"n": fam_x.numel()}),
        "stockham_fft": ((fam_x[:128 * 512].reshape(128, 512),), {},
                         {"n": 512}),
        "svm": ((normal(128, sv_main.shape[1]), sv_main, alpha_main,
                 stages[3].consts[2]), {"gamma": 0.5},
                {"q": 128, "m": sv_main.shape[0], "d": sv_main.shape[1]}),
    }
    opt_queues = {
        "default": ({}, False),
        "unprofiled blocking": ({"profile": False, "blocking": True}, True),
        "windowed": ({"profile": True, "max_events": 2}, True),
    }
    prog16 = Program.build(EGPU_16T)
    ctx16 = Context(Device(EGPU_16T), "cuda")
    opt_runs = {}
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    for qname, (qopts, tblock) in opt_queues.items():
        q = CommandQueue(ctx16, **qopts)
        kernel_events, outs = [], {}
        for family, (ins, params, cps) in fam_in.items():
            src = ctx16.create_buffer(torch.empty_like(ins[0]))
            wr = q.enqueue_write_buffer(src, ins[0], blocking=tblock)
            ev = q.enqueue_nd_range(
                prog16.create_kernel(family),
                optimal_ndrange(ins[0].numel(), EGPU_16T),
                (src,) + tuple(ctx16.create_buffer(a) for a in ins[1:]),
                params=params, counts_params=cps)
            ev_done = ev.done
            rd = q.enqueue_read_buffer(ev.outputs[0], blocking=tblock)
            if q.blocking:
                check(ev_done, f"4d {qname}: {family} not done on return")
            if tblock:
                check(wr.done and rd.done and ev.done,
                      f"4d {qname}: {family}: a blocking transfer returned "
                      "before its work was done")
            check(wr.dispatch_s == 0.0 and rd.dispatch_s == 0.0,
                  f"4d {qname}: a transfer booked host dispatch time")
            kernel_events.append(ev)
            outs[family] = tuple(b.data for b in ev.outputs)
        check(q.flush() is None, f"4d {qname}: flush returned something")
        q.finish()
        opt_runs[qname] = (q, kernel_events, outs)
    torch.cuda.synchronize()
    opt_wall = time.perf_counter() - t0
    opt_launches = dict(common.LAUNCHES)
    for name in KERNELS:
        want = len(opt_queues) if name in fam_in else 0
        check(opt_launches[name] == want,
              f"phase 4d launched {name} {opt_launches[name]} times, expected "
              f"{want} (one launch an enqueue)")
    n_cmds = 3 * len(fam_in)
    (q_def, ev_def, out_def) = opt_runs["default"]
    for qname, (q, evs, outs) in opt_runs.items():
        for family, got in outs.items():
            check(len(got) == len(out_def[family]) and all(
                same_bits(a_, b_) for a_, b_ in zip(got, out_def[family])),
                f"4d {qname}: {family} output differs from the default queue's")
        for ev in evs:
            check(ev.dispatch_s > 0.0 and ev.wall_s == ev.dispatch_s,
                  f"4d {qname}: {ev.kernel.name} dispatch_s {ev.dispatch_s}")
    q_unp, ev_unp, _ = opt_runs["unprofiled blocking"]
    check(q_unp.events == () and q_unp.released_count == n_cmds
          and all(e.released and e.modeled is None for e in ev_unp),
          f"4d unprofiled finish: {len(q_unp.events)} events kept, "
          f"{q_unp.released_count} released, expected () and {n_cmds}")
    q_win, ev_win, _ = opt_runs["windowed"]
    check(len(q_win.events) == 2 and q_win.released_count == n_cmds - 2,
          f"4d windowed queue kept {len(q_win.events)} events")
    check((q_win.total_modeled_s(), q_win.total_energy_j())
          == (q_def.total_modeled_s(), q_def.total_energy_j()),
          "4d windowed totals differ from the full-history queue's: "
          f"{q_win.total_modeled_s()!r} s / {q_win.total_energy_j()!r} J vs "
          f"{q_def.total_modeled_s()!r} s / {q_def.total_energy_j()!r} J")
    check(all(e.released and e.dispatch_s > 0.0 for e in ev_win[:-1]),
          "4d windowed queue: released events lost their dispatch_s")
    launches.update({name: launches[name] + opt_launches[name] for name in fam_in})
    # create_buffer: adoption and aliasing of a card tensor, a fresh copy on
    # request, and a CPU tensor that a card context cannot adopt
    card_t = fam_x[:1024]
    for kw in ({"copy": False}, {"use_host_ptr": True}):
        b_ = ctx16.create_buffer(card_t, **kw)
        check(b_.data is card_t and b_.data.data_ptr() == card_t.data_ptr(),
              f"4d create_buffer({kw}) did not alias the card tensor")
    fresh = ctx16.create_buffer(card_t, copy=True).data
    check(fresh.is_cuda and fresh.data_ptr() != card_t.data_ptr()
          and torch.equal(fresh, card_t), "4d create_buffer(copy=True) aliased")
    try:
        ctx16.create_buffer(card_t.cpu(), copy=False)
    except TypeError as e:
        adopt_err = str(e)
    else:
        raise SmokeFailure("4d create_buffer adopted a CPU tensor on the card")
    def_ev = {e.kernel.name: e.dispatch_s for e in ev_def}
    blk_ev = {e.kernel.name: e.dispatch_s for e in ev_unp}
    log(f"phase 4d: queue options on the card (gemm 256^3 int32, fir "
        f"{fam_x.numel()} x {h.numel()}, delineate, fft 128 x 512, svm 128 x "
        f"{sv_main.shape[0]} x {sv_main.shape[1]}; default, unprofiled "
        f"blocking, windowed max_events=2) in {opt_wall:.3f} s: outputs "
        f"bit-equal to the default queue's, blocking events done on return, "
        f"unprofiled finish released {q_unp.released_count}, windowed totals "
        f"== full history ({q_win.total_modeled_s()!r} s, "
        f"{q_win.total_energy_j()!r} J), launches {opt_launches}; "
        f"create_buffer aliases a card tensor, copies on copy=True, refuses a "
        f"CPU tensor ({adopt_err!r})")
    log("phase 4d: dispatch_s per kernel (ms), async / blocking: " + ", ".join(
        f"{k_} {def_ev[k_] * 1e3:.3f} / {blk_ev[k_] * 1e3:.3f}" for k_ in def_ev))
    disp = bench_dispatch.run("cuda")
    us = disp["per_launch_us"]
    log(f"phase 4d: bench_dispatch on the card (chain of {disp['chain_len']} "
        f"{disp['size']}^2 f32 GeMMs, best of {disp['trials']}x{disp['reps']}): "
        f"eager-sync {us['eager-sync']:.3f}, async {us['async']:.3f}, graph "
        f"{us['graph']:.3f} us a kernel; graph {us['async'] / us['graph']:.3f}x "
        f"cheaper than async, {disp['graph_vs_eager_sync_speedup']:.3f}x than "
        f"eager-sync")
    static_rows = bench_static.run()
    check(len(static_rows) == 4 and all(
        math.isfinite(r_[k_]) for r_ in static_rows for k_ in r_ if k_ != "name"),
        "bench_static rows are not 4 rows of finite numbers")
    log("phase 4d: bench_static rows (no device runs them; the CPU tests hold "
        "them == the JAX rows): " + json.dumps(static_rows))

    # -- 5. the LM serving path: qwen2.5-3b, full width and depth, bf16 -----
    phase_done("5")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer(lm_cfg, init_params(model_spec(lm_cfg), 0, device=dev))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 5: {LM_ARCH}: {lm_cfg.n_layers} layers, d_model "
        f"{lm_cfg.d_model}, {lm_h} heads over {lm_kvh} kv heads of {lm_d}, "
        f"d_ff {lm_cfg.d_ff}, vocab {lm_cfg.vocab} (padded "
        f"{lm_cfg.vocab_padded}); {n_params} parameters in {lm_cfg.dtype}, "
        f"initialised from seed 0 on the card in {time.perf_counter() - t0:.3f} s")
    prompt = np.random.default_rng(0).integers(
        0, lm_cfg.vocab, (LM_BATCH, LM_PROMPT))

    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    tokens = greedy_generate(model, prompt, LM_NEW, LM_MAX_LEN)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    lm_launches = dict(common.LAUNCHES)
    lm_want = model_launches(lm_cfg, 1, LM_NEW - 1,
                             flash_attention=lm_cfg.n_layers)
    for name in KERNELS:
        want = lm_want.get(name, 0)
        check(lm_launches[name] == want,
              f"LM main path launched {name} {lm_launches[name]} times, "
              f"expected {want} (flash_attention once a layer of the "
              f"prefill, decode_attention once a layer of each of "
              f"{LM_NEW - 1} decode steps, norm at every norm)")
    launches.update({name: lm_launches[name] for name in LM_KERNELS})
    launches["norm"] = lm_launches["norm"]
    launches["decode_attention"] += lm_launches["decode_attention"]
    check(tokens.is_cuda and tokens.dtype == torch.int32
          and tokens.shape == (LM_BATCH, LM_NEW)
          and bool(((tokens >= 0) & (tokens < lm_cfg.vocab)).all()),
          "greedy tokens are not (4, 16) int32 ids below the vocabulary")
    t0 = time.perf_counter()
    again = greedy_generate(model, prompt, LM_NEW, LM_MAX_LEN)
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    check(torch.equal(tokens, again), "greedy tokens differ on a second run")
    log(f"phase 5: greedy_generate {LM_BATCH} x {LM_PROMPT}-token prompts, "
        f"{LM_NEW} new tokens each, max_len {LM_MAX_LEN}: first run "
        f"{first_wall:.3f} s, second {warm_wall:.3f} s, "
        f"{LM_BATCH * LM_NEW / warm_wall:.1f} tokens/s; launches {lm_launches}; "
        f"same tokens on both runs; first request's tokens "
        f"{tokens[0].tolist()}")

    # the steps one at a time: prefill moves flash_attention by one launch
    # per layer, a decode step decode_attention by one a layer; each moves
    # norm once a norm
    prefill_step = make_prefill_step(lm_cfg, LM_MAX_LEN)
    decode_fn = make_decode_step(lm_cfg)
    ptoks = {"tokens": torch.from_numpy(prompt).to(dev)}
    before = dict(common.LAUNCHES)
    t0 = time.perf_counter()
    logits, cache = prefill_step(model, ptoks)
    torch.cuda.synchronize()
    prefill_wall = time.perf_counter() - t0
    want = model_launches(lm_cfg, 1, 0, flash_attention=lm_cfg.n_layers)
    check(all(common.LAUNCHES[k_] - before[k_] == want.get(k_, 0)
              for k_ in KERNELS),
          f"a prefill did not launch {want}: "
          f"{ {k_: common.LAUNCHES[k_] - before[k_] for k_ in KERNELS} }")
    check(logits.shape == (LM_BATCH, lm_cfg.vocab_padded)
          and bool(torch.isfinite(logits[:, :lm_cfg.vocab]).all())
          and bool((logits[:, lm_cfg.vocab:] == -1e30).all()),
          "prefill logits: shape, finiteness or padding columns")
    tok = torch.argmax(logits, -1).to(torch.int32)
    steps = [tok]
    # kept for phase 12c, which serves the same model under the sharding
    # rules and must give these bits
    lm_ref = {"prompt": ptoks["tokens"].cpu(), "prefill": logits.cpu(),
              "steps": [], "prefill_wall": prefill_wall}
    before = dict(common.LAUNCHES)
    t0 = time.perf_counter()
    for i in range(LM_NEW - 1):
        tok, step_logits, cache = decode_fn(model, cache, tok, LM_PROMPT + i)
        steps.append(tok)
        lm_ref["steps"].append(step_logits)
    torch.cuda.synchronize()
    decode_wall = (time.perf_counter() - t0) / (LM_NEW - 1)
    lm_ref["steps"] = [x.cpu() for x in lm_ref["steps"]]
    lm_ref["tokens"] = torch.stack(steps, 1).cpu()
    lm_ref["decode_wall"] = decode_wall
    want = model_launches(lm_cfg, 0, LM_NEW - 1)
    check(all(common.LAUNCHES[k_] - before[k_] == want.get(k_, 0)
              for k_ in KERNELS),
          f"{LM_NEW - 1} decode steps did not launch {want}: "
          f"{ {k_: common.LAUNCHES[k_] - before[k_] for k_ in KERNELS} }")
    check(torch.equal(torch.stack(steps, 1), tokens),
          "prefill + decode steps differ from greedy_generate")
    log(f"phase 5: prefill wall {prefill_wall * 1e3:.3f} ms "
        f"({LM_BATCH * LM_PROMPT} prompt tokens), decode step wall "
        f"{decode_wall * 1e3:.3f} ms (mean of {LM_NEW - 1}, {LM_BATCH} "
        f"sequences)")
    p_wall, p_busy, p_kernels = device_profile(
        torch, lambda: prefill_step(model, ptoks))
    log("phase 5: " + profile_line("one prefill", p_wall, p_busy, p_kernels))
    library = [k for k in p_kernels
               if any(t in k.lower() for t in LIBRARY_ATTENTION)]
    check(not library, f"the prefill ran library attention kernels: {library}")
    ours = [k for k in p_kernels if any(n in k for n in FLASH_KERNEL_NAMES)]
    check(bool(ours), "the prefill's profile shows no hand-written "
          "flash-attention kernel")
    d_wall, d_busy, d_kernels = device_profile(
        torch, lambda: decode_fn(model, cache, tok, LM_PROMPT + LM_NEW - 1))
    log("phase 5: " + profile_line("one decode step", d_wall, d_busy, d_kernels))
    check_step_kernels(d_kernels, f"{LM_ARCH} decode step", lm_cfg)
    log(f"phase 5: a prefill launches norm {norms_per_pass(lm_cfg)} times "
        f"and flash_attention {lm_cfg.n_layers}; a decode step norm "
        f"{norms_per_pass(lm_cfg)} and decode_attention "
        f"{attn_layers(lm_cfg)} (exact counts); the profiled step ran no "
        f"PyTorch norm reduction ({', '.join(NORM_REDUCTIONS)})")
    log(f"phase 5: hand-written attention kernels in the prefill: {ours}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
        f"GiB (the f32 init tree beside the bf16 model included)")
    del model, cache, logits
    torch.cuda.empty_cache()

    # -- 5b. the card against the CPU: a 2-layer cut at full width, f32 ----
    phase_done("5b")
    cut = dataclasses.replace(lm_cfg, n_layers=2, dtype="float32")
    cut_err, _ = card_against_cpu(torch, np, dev, cut, "the qwen cut")
    log("phase 5b: 2-layer full-width f32 cut, card vs CPU: greedy tokens "
        "equal over prefill + 4 decode steps; logits error / max |logit| "
        + ", ".join(f"{e:.3g}" for e in cut_err))

    # -- 6. the rwkv serving path: rwkv6-3b, full width and depth, bf16 ----
    phase_done("6")
    # 32 layers of 40 heads of 64, random weights from seed 0 on the card
    # (the qwen model above is freed first).  rwkv6_scan must launch once
    # per layer in the prefill and once per layer in every decode step, and
    # no other kernel of ours.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rw_model = Transformer(rw_cfg, init_params(model_spec(rw_cfg), 0, device=dev))
    torch.cuda.synchronize()
    rw_params = sum(p_.numel() for p_ in rw_model.parameters())
    log(f"phase 6: {RWKV_ARCH}: {rw_cfg.n_layers} layers, d_model "
        f"{rw_cfg.d_model}, {rw_h} heads of {rw_d}, d_ff {rw_cfg.d_ff}, vocab "
        f"{rw_cfg.vocab}; {rw_params} parameters in the model's tree "
        f"(ModelConfig.param_count() says {rw_cfg.param_count()}: it counts "
        f"the decay lora at rank 32, the spec at 64), {rw_cfg.dtype}, "
        f"initialised from seed 0 on the card in {time.perf_counter() - t0:.3f} s")
    rw_prompt = np.random.default_rng(0).integers(
        0, rw_cfg.vocab, (RWKV_BATCH, RWKV_PROMPT))
    n_layers = rw_cfg.n_layers

    def only_rwkv(moved, passes, what):
        """rwkv6_scan once a layer and norm at every norm of each of
        ``passes`` prefills or steps, nothing else of ours."""
        want = model_launches(rw_cfg, passes, 0,
                              rwkv6_scan=n_layers * passes)
        for name in KERNELS:
            expect = want.get(name, 0)
            check(moved[name] == expect,
                  f"{what} launched {name} {moved[name]} times, expected {expect}")

    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    rw_tokens = greedy_generate(rw_model, rw_prompt, RWKV_NEW, RWKV_MAX_LEN)
    torch.cuda.synchronize()
    rw_first = time.perf_counter() - t0
    rw_launches = dict(common.LAUNCHES)
    only_rwkv(rw_launches, RWKV_NEW,
              "the rwkv main path (one prefill and 15 decode steps)")
    launches.update({name: rw_launches[name] for name in RWKV_KERNELS})
    launches["norm"] += rw_launches["norm"]
    check(rw_tokens.is_cuda and rw_tokens.dtype == torch.int32
          and rw_tokens.shape == (RWKV_BATCH, RWKV_NEW)
          and bool(((rw_tokens >= 0) & (rw_tokens < rw_cfg.vocab)).all()),
          "rwkv greedy tokens are not (4, 16) int32 ids below the vocabulary")
    t0 = time.perf_counter()
    rw_again = greedy_generate(rw_model, rw_prompt, RWKV_NEW, RWKV_MAX_LEN)
    torch.cuda.synchronize()
    rw_warm = time.perf_counter() - t0
    check(torch.equal(rw_tokens, rw_again), "rwkv greedy tokens differ on a second run")
    log(f"phase 6: greedy_generate {RWKV_BATCH} x {RWKV_PROMPT}-token prompts, "
        f"{RWKV_NEW} new tokens each: first run {rw_first:.3f} s, second "
        f"{rw_warm:.3f} s, {RWKV_BATCH * RWKV_NEW / rw_warm:.1f} tokens/s; "
        f"launches {rw_launches}; same tokens on both runs; first request's "
        f"tokens {rw_tokens[0].tolist()}")

    # the steps one at a time: the prefill and each decode step move
    # rwkv6_scan by one launch per layer
    rw_prefill_step = make_prefill_step(rw_cfg, RWKV_MAX_LEN)
    rw_decode_fn = make_decode_step(rw_cfg)
    rw_ptoks = {"tokens": torch.from_numpy(rw_prompt).to(dev)}
    before = dict(common.LAUNCHES)
    t0 = time.perf_counter()
    rw_logits, rw_cache = rw_prefill_step(rw_model, rw_ptoks)
    torch.cuda.synchronize()
    rw_prefill_wall = time.perf_counter() - t0
    only_rwkv({k_: common.LAUNCHES[k_] - before[k_] for k_ in before}, 1,
              "an rwkv prefill")
    check(rw_logits.shape == (RWKV_BATCH, rw_cfg.vocab_padded)
          and bool(torch.isfinite(rw_logits[:, :rw_cfg.vocab]).all()),
          "rwkv prefill logits: shape or finiteness")
    tok = torch.argmax(rw_logits, -1).to(torch.int32)
    steps = [tok]
    step_walls = []
    for i in range(RWKV_NEW - 1):
        before = dict(common.LAUNCHES)
        t0 = time.perf_counter()
        tok, _, rw_cache = rw_decode_fn(rw_model, rw_cache, tok, RWKV_PROMPT + i)
        torch.cuda.synchronize()
        step_walls.append(time.perf_counter() - t0)
        only_rwkv({k_: common.LAUNCHES[k_] - before[k_] for k_ in before},
                  1, f"rwkv decode step {i}")
        steps.append(tok)
    check(torch.equal(torch.stack(steps, 1), rw_tokens),
          "rwkv prefill + decode steps differ from greedy_generate")
    rw_decode_wall = sum(step_walls) / len(step_walls)
    log(f"phase 6: prefill wall {rw_prefill_wall * 1e3:.3f} ms "
        f"({RWKV_BATCH * RWKV_PROMPT} prompt tokens), decode step wall "
        f"{rw_decode_wall * 1e3:.3f} ms (mean of {RWKV_NEW - 1}, {RWKV_BATCH} "
        f"sequences); {n_layers} rwkv6_scan and {norms_per_pass(rw_cfg)} "
        f"norm launches per prefill and per step")
    rp_wall, rp_busy, rp_kernels = device_profile(
        torch, lambda: rw_prefill_step(rw_model, rw_ptoks))
    log("phase 6: " + profile_line("one rwkv prefill", rp_wall, rp_busy, rp_kernels))
    check(any("rwkv6_kernel" in k_ for k_ in rp_kernels),
          "the rwkv prefill's profile shows no rwkv6_kernel")
    scan_us = sum(v_ for k_, v_ in rp_kernels.items() if "rwkv6_kernel" in k_)
    log(f"phase 6: rwkv6_kernel in the profiled prefill: {scan_us / 1e3:.4f} ms "
        f"for {n_layers} launches, of {rp_busy * 1e3:.4f} ms busy")
    rd_wall, rd_busy, rd_kernels = device_profile(
        torch, lambda: rw_decode_fn(rw_model, rw_cache, tok,
                                    RWKV_PROMPT + RWKV_NEW - 1))
    log("phase 6: " + profile_line("one rwkv decode step", rd_wall, rd_busy, rd_kernels))
    check(any("rwkv6_step_kernel" in k_ for k_ in rd_kernels),
          "the rwkv decode step's profile shows no rwkv6_step_kernel")
    check_step_kernels(rd_kernels, f"{RWKV_ARCH} decode step", rw_cfg)
    log(f"phase 6: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB (the f32 init "
        f"tree beside the bf16 model included)")
    del rw_model, rw_cache, rw_logits
    torch.cuda.empty_cache()

    # -- 6b. the card against the CPU: a 2-layer rwkv cut at full width, f32
    phase_done("6b")
    rw_cut = dataclasses.replace(rw_cfg, n_layers=2, dtype="float32")
    rw_cut_err, _ = card_against_cpu(torch, np, dev, rw_cut, "the rwkv cut",
                                     kernel="rwkv6_scan", per_step=1)
    log("phase 6b: 2-layer full-width f32 rwkv cut, card vs CPU: greedy tokens "
        "equal over prefill + 4 decode steps; logits error / max |logit| "
        + ", ".join(f"{e:.3g}" for e in rw_cut_err))

    # -- 7. TinyBio served on the card, at full size -----------------------------
    phase_done("7")
    # Server over two lanes (16T and 8T), exact-fit bucket (the features
    # reduce over the whole signal), micro-batches of 4, warmed up first; 16
    # requests from synth_signal(n, seed), seeds 0..15.  The counters are
    # reset just before the served run and read just after it.
    from repro_torch.obs import Tracer, validate_chrome_trace
    from repro_torch.serve import Blackout, FaultPlan, QueueWorker, Server
    n_sig = x.numel()
    serve_stages, _ = tinybio.tinybio_stages(EGPU_16T, 0, dev)
    cpu_serve_stages, _ = tinybio.tinybio_stages(EGPU_16T, 0, "cpu")
    signals = [tinybio.synth_signal(n_sig, s_) for s_ in range(16)]
    serve_batch = 4

    def make_server(device, **kw):
        return Server(serve_stages if device == "cuda" else cpu_serve_stages,
                      workers=(QueueWorker(EGPU_16T, device=device),
                               QueueWorker(EGPU_8T, device=device)),
                      bucket_sizes=(n_sig,), max_batch=serve_batch,
                      device=device, **kw)

    def serve(srv, vclock=None):
        rids = []
        for i_, sig_ in enumerate(signals):
            if vclock is not None:
                vclock.t = 1e-4 * i_
            rids.append(srv.submit(sig_))
        if vclock is not None:
            vclock.t = 1e-4 * len(signals) + 1e-3
        srv.flush()
        return [srv.result(r_) for r_ in rids]

    srv = make_server("cuda")
    warmed = srv.warmup(signals[0])
    check(warmed == 2 and srv.cache.misses == 2,
          f"warmup captured {warmed} graphs, expected 2 (2 lanes x 1 bucket)")
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    served = serve(srv)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    serve_launches = dict(common.LAUNCHES)
    n_batches = len(signals) // serve_batch
    for name in KERNELS:
        want = n_batches if name in TINYBIO_KERNELS else 0
        check(serve_launches[name] == want,
              f"served TinyBio launched {name} {serve_launches[name]} times, "
              f"expected {want} (one launch a stage a micro-batch)")
    check(srv.cache.misses == 2 and srv.cache.hits == n_batches,
          f"served TinyBio cache {srv.cache.stats()}: a miss after warmup")
    # every request's outputs bit-equal to APU.offload of it alone on the card
    apu_serve = APU(EGPU_16T, device="cuda")
    offload_walls = []
    for i_, sig_ in enumerate(signals):
        sx = torch.from_numpy(sig_).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_outs, _ = apu_serve.offload(serve_stages, (sx,))
        torch.cuda.synchronize()
        offload_walls.append(time.perf_counter() - t0)
        (got_,) = served[i_]
        check(got_.is_cuda and got_.shape == (128,) and bool(torch.isfinite(got_).all()),
              f"served request {i_}: not 128 finite decisions on the card")
        check(same_bits(got_, ref_outs[0].data),
              f"served request {i_} differs from its own APU.offload")
    rep_main = srv.report()
    log(f"phase 7: served {len(signals)} TinyBio requests (n={n_sig}) over lanes "
        f"{[w_.name for w_ in srv.dispatcher.workers]} in {n_batches} micro-batches "
        f"of {serve_batch}: launches {serve_launches}; cache {srv.cache.stats()}; "
        f"every request bit-equal to its own APU.offload on the card")
    # modeled fields on a virtual clock: the card's run equals the CPU's
    vc_card, vc_cpu = VClock(), VClock()
    srv_vc = make_server("cuda", clock=vc_card)
    srv_vc.warmup(signals[0])
    outs_vc = serve(srv_vc, vc_card)
    srv_cpu = make_server("cpu", clock=vc_cpu)
    srv_cpu.warmup(signals[0])
    outs_cpu = serve(srv_cpu, vc_cpu)
    check(modeled_report(srv_vc.report()) == modeled_report(srv_cpu.report()),
          "served TinyBio: a modeled ServeReport field differs between card and CPU")
    check(all(same_bits(a_[0], b_[0]) for a_, b_ in zip(outs_vc, served)),
          "served TinyBio on a virtual clock differs from the real-clock run")
    dec_err = max(err(a_[0].cpu(), b_[0]) for a_, b_ in zip(outs_vc, outs_cpu))
    check(dec_err <= 1e-6, f"served decisions card vs CPU differ by {dec_err}")
    # a traced twin: complete request trees, a valid Chrome trace, the bits
    # and modeled report of the untraced run
    tracer = Tracer()
    vc_tr = VClock()
    srv_tr = make_server("cuda", clock=vc_tr, tracer=tracer)
    srv_tr.warmup(signals[0])
    outs_tr = serve(srv_tr, vc_tr)
    tree_errors = tracer.validate_request_trees()
    check(tree_errors == [], f"traced serving: request trees {tree_errors[:3]}")
    trace_doc = tracer.to_chrome_json()
    schema_errors = validate_chrome_trace(trace_doc)
    check(schema_errors == [], f"traced serving: chrome trace {schema_errors[:3]}")
    check(all(same_bits(a_[0], b_[0]) for a_, b_ in zip(outs_tr, outs_vc)),
          "traced serving changed the outputs")
    check(modeled_report(srv_tr.report()) == modeled_report(srv_vc.report()),
          "tracing perturbed the modeled report")
    # faults: the 16T lane blacked out for its first two launches plus
    # seeded launch failures; every failed attempt retries on a lane, and
    # the retried batches give the fault-free bits
    plan = FaultPlan(seed=0, p_launch_fail=0.25,
                     blackouts=(Blackout("e-gpu-16t", 0, 2),))
    vc_f = VClock()
    srv_f = make_server("cuda", clock=vc_f, fault_plan=plan)
    srv_f.warmup(signals[0])
    outs_f = serve(srv_f, vc_f)
    rep_f = srv_f.report()
    check(rep_f.n_retries > 0 and rep_f.n_shed == 0 and rep_f.n_requests == len(signals),
          f"fault run: {rep_f.n_retries} retries, {rep_f.n_shed} shed, "
          f"{rep_f.n_requests} served")
    check(all(same_bits(a_[0], b_[0]) for a_, b_ in zip(outs_f, outs_vc)),
          "retried batches differ from the fault-free run")
    log(f"phase 7: virtual clock: every modeled ServeReport field == the CPU run's "
        f"(decisions card vs CPU within {dec_err:.3g}); traced twin: "
        f"{len(tracer.spans)} spans, {len(tracer.request_rids())} complete request "
        f"trees, Chrome trace valid, bits and report unperturbed; fault run: "
        f"{plan.injected_failures} injected failures, {rep_f.n_retries} retries, "
        f"{rep_f.n_quarantines} quarantines, 0 shed, bits equal")
    # where one warm batch launch's time goes (submit 4 requests -> one
    # launch, flush retires it), beside a warm APU.offload graph wall
    batch_prof = device_profile(torch, lambda: (
        [srv.submit(sig_) for sig_ in signals[:serve_batch]], srv.flush()))
    sx0 = torch.from_numpy(signals[0]).to(dev)
    offload_prof = device_profile(torch, lambda: apu_serve.offload(serve_stages, (sx0,)))
    log(f"phase 7: serving wall {serve_wall * 1e3:.3f} ms for {len(signals)} requests: "
        f"{serve_wall / len(signals) * 1e3:.3f} ms a request, "
        f"{len(signals) / serve_wall:.1f} requests/s (report: "
        f"{rep_main.requests_per_s:.1f}); per-request APU.offload graph wall (host "
        f"capture included) median {sorted(offload_walls)[len(offload_walls) // 2] * 1e3:.3f} ms, "
        f"min {min(offload_walls) * 1e3:.3f} ms")
    log("phase 7: " + profile_line("one warm served micro-batch of 4 (submit + "
                                   "launch + retire)", *batch_prof))
    log("phase 7: " + profile_line("one warm 16T APU.offload graph of one request",
                                   *offload_prof))
    launches.update({name: launches[name] + serve_launches[name]
                     for name in TINYBIO_KERNELS})

    # -- 7b. the overload and power serving benches on the card ---------------
    phase_done("7b")
    # Every modeled row (the whole result) must equal the same bench's CPU
    # run; the benches' own gates and bit-identity asserts hold inside run().
    for bench in (bench_overload, bench_power):
        t0 = time.perf_counter()
        on_card = bench.run("cuda")
        torch.cuda.synchronize()
        card_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = bench.run("cpu")
        cpu_wall = time.perf_counter() - t0
        for key in on_cpu:
            check(on_card[key] == on_cpu[key],
                  f"{bench.__name__} {key}: {on_card[key]} on the card, "
                  f"{on_cpu[key]} on the CPU")
        log(f"phase 7b: {bench.__name__.rsplit('.', 1)[-1]}: every modeled row "
            f"== the CPU run's; wall {card_wall:.3f} s on the card, "
            f"{cpu_wall:.3f} s on the CPU; " + json.dumps(
                {k_: on_card[k_] for k_ in (
                    "goodput_vs_fifo_speedup", "goodput_faulted_vs_fifo_speedup",
                    "n_bit_identity_checked", "goodput_per_watt_speedup",
                    "n_power_throttled") if k_ in on_card}))

    # -- 8. the decode engine on the card: qwen2.5-3b and rwkv6-3b -------------
    phase_done("8")
    # serve_engine at full width and depth on the JAX-layout f32 tree, as
    # init_params makes it (benchmarks_torch/batch_bits.py finds every op of
    # a B = 1 prefill and a B = 4 step giving its rows the bits of B = 6; at
    # B = 1 or 2 a step's f32 mean and bmm do not, so the tokens of a prompt
    # decoded alone may part); every modeled stats() field must equal the
    # same workload's on the CPU over a 2-layer f32 cut at full width (as
    # 5b cuts).
    for cfg_, label, ours in (
            (lm_cfg, LM_ARCH, {"flash_attention": (lm_cfg.n_layers, 0)}),
            (rw_cfg, RWKV_ARCH, {"rwkv6_scan": (rw_cfg.n_layers,
                                                rw_cfg.n_layers)})):
        e = serve_engine(torch, np, dev, cfg_, ours)
        cut = dataclasses.replace(cfg_, n_layers=2, dtype="float32")
        stats_match_cpu(torch, np, dev, cut,
                        init_params(model_spec(cut), 0, device="cpu"), label)
        for name in (*ours, "norm", "decode_attention"):
            launches[name] += e["launches"][name]
        log(f"phase 8: {label}: DecodeEngine({ENGINE_SLOTS} slots, max_len "
            f"{ENGINE_MAX_LEN}, bf16 cache) behind an engine-only Server: "
            f"{ENGINE_REQUESTS} staggered requests of {ENGINE_PROMPT} tokens, "
            f"{ENGINE_NEW} new each, in {e['n_steps']} steps; tokens == "
            f"greedy_generate of the six prompts as one batch and of each "
            f"alone; 2 cache "
            f"misses (capture run {e['capture_wall']:.3f} s); launches "
            f"{e['launches']}; "
            f"first request's tokens {e['first']}")
        log(f"phase 8: {label} on {card}: served wall {e['served_wall']:.3f} s, "
            f"{e['tokens_per_s']:.1f} tokens/s of wall; warm prefill (B = 1, "
            f"{ENGINE_PROMPT} tokens) wall {e['prefill_ms']:.3f} ms (median "
            f"of 3); warm step ({ENGINE_SLOTS} slots, tokens read back) wall "
            f"{e['step_ms']:.3f} ms (median of 5); peak device memory "
            f"{e['peak_gib']:.3f} GiB (the f32 tree beside the bf16 model "
            f"included); 2-layer f32 cut: every stats() field == the CPU's")
        log(f"phase 8: {label}: " + profile_line("one warm engine step",
                                                 *e["profile"]))
        log(f"phase 8: {label}: " + profile_line("one warm engine prefill",
                                                 *e["prefill_profile"]))
        log(f"phase 8: {label}: stats " + json.dumps(e["stats"]))

    # -- 9. the MoE and MLA blocks: moonshot-v1-16b-a3b, deepseek-v2-236b -----
    phase_done("9")
    # Phases 5-8's models, caches and cuts are freed by then; each
    # family is served through the decode engine at full width on a bf16
    # tree (moonshot 48 layers; deepseek its dense first layer and three
    # MLA + MoE layers), then an f32 cut of each is held against the
    # CPU (deepseek's shared experts and dense first layer run on the card
    # only in its runs here).
    torch.cuda.empty_cache()
    log(f"phase 9: device memory before the phase: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated")
    for arch, n_layers_, _ in MOE_ARCHS:
        cfg_ = dataclasses.replace(get_arch(arch), n_layers=n_layers_)
        e = serve_engine(torch, np, dev, cfg_,
                         {"flash_attention": (cfg_.n_layers, 0)},
                         tree_dtype=torch.bfloat16)
        for name in ("flash_attention", "norm", "decode_attention"):
            launches[name] += e["launches"][name]
        log(f"phase 9: {arch}: {cfg_.n_layers} layers at full width "
            f"(d_model {cfg_.d_model}, {cfg_.n_heads} heads, Dk {e['dims'][0]}"
            f" / Dv {e['dims'][1]}, {cfg_.n_experts} experts of {cfg_.d_ff_expert}, top-"
            f"{cfg_.top_k}, {cfg_.n_shared_experts} shared"
            + (", dense first layer" if cfg_.first_layer_dense else "")
            + f"), {e['n_params']} parameters drawn in bf16 on the card in "
            f"{e['init_s']:.3f} s ({e['model_gib']:.3f} GiB allocated with "
            f"the engine; its modeled bytes are this bf16 tree's); "
            f"DecodeEngine({ENGINE_SLOTS} slots, max_len {ENGINE_MAX_LEN}): "
            f"{ENGINE_REQUESTS} staggered requests of {ENGINE_PROMPT} tokens, "
            f"{ENGINE_NEW} new each, in {e['n_steps']} steps; tokens == "
            f"greedy_generate of the six prompts as one batch and of each "
            f"alone; 2 cache "
            f"misses (capture run {e['capture_wall']:.3f} s); launches "
            f"{e['launches']}; the prefill ran {e['flash']}; first request's "
            f"tokens {e['first']}")
        log(f"phase 9: {arch} on {card}: served wall {e['served_wall']:.3f} s, "
            f"{e['tokens_per_s']:.1f} tokens/s of wall; warm prefill (B = 1, "
            f"{ENGINE_PROMPT} tokens) wall {e['prefill_ms']:.3f} ms (median "
            f"of 3); warm step ({ENGINE_SLOTS} slots, tokens read back) wall "
            f"{e['step_ms']:.3f} ms (median of 5); peak device memory "
            f"{e['peak_gib']:.3f} GiB")
        log(f"phase 9: {arch}: " + profile_line("one warm engine step",
                                                *e["profile"]))
        log(f"phase 9: {arch}: " + profile_line("one warm engine prefill",
                                                *e["prefill_profile"]))
        log(f"phase 9: {arch}: stats " + json.dumps(e["stats"]))
    for arch, _, cut_layers in MOE_ARCHS:
        cut = dataclasses.replace(get_arch(arch), n_layers=cut_layers,
                                  dtype="float32")
        t0 = time.perf_counter()
        cut_errs, cut_tree = card_against_cpu(torch, np, dev, cut, arch)
        stats_match_cpu(torch, np, dev, cut, cut_tree, arch)
        n_cut = sum(t.numel() for _, t in leaves_with_path(cut_tree))
        log(f"phase 9: {arch}: {cut_layers}-layer full-width f32 cut"
            + (" (the dense first layer and one MLA + MoE layer with its "
               "shared experts)" if cut.first_layer_dense else "")
            + f", {n_cut * 4 / 1e9:.1f} GB, card vs CPU: greedy tokens equal "
            f"over prefill + 4 decode steps; logits error / max |logit| "
            + ", ".join(f"{x_:.3g}" for x_ in cut_errs)
            + f"; every stats() field of the staggered engine run == the "
            f"CPU's; {time.perf_counter() - t0:.1f} s")
        del cut_tree
    torch.cuda.empty_cache()

    # -- 10. the Mamba block and the vision frontend: jamba, paligemma --------
    phase_done("10")
    # Phase 9's models are freed by then.  10a serves jamba's first four
    # layers at full width through the decode engine (mamba_scan on every
    # prefill's mamba layers); 10b serves paligemma at full width and depth
    # with image + text requests (flash_attention at Dk = Dv = 256).
    torch.cuda.empty_cache()
    log(f"phase 10: device memory before the phase: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated")
    moved = serve_mamba(torch, np, dev, get_arch(MAMBA_ARCH), card)
    for name in ("mamba_scan", "flash_attention", "norm", "decode_attention"):
        launches[name] += moved[name]
    moved = serve_vision(torch, np, dev, get_arch(PALI_ARCH), card)
    for name in ("flash_attention", "norm", "decode_attention"):
        launches[name] += moved[name]

    # -- 11. the training path: stablelm, the 86M example, hubert, 11d-11i -------
    phase_done("11")
    # Phase 10's models are freed by then.  11a trains stablelm-1.6b at full
    # width and depth through the launcher's train_loop (flash_attention and
    # flash_attention_bwd on every layer of every step) and holds a 2-layer
    # f32 cut to the CPU; 11b trains the example model and restarts it from
    # a checkpoint; 11c encodes with hubert (forward without a gradient).
    torch.cuda.empty_cache()
    log(f"phase 11: device memory before the phase: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated")
    moved = [train_full(torch, np, dev, get_arch(TRAIN_ARCH), card)]
    train_cut(torch, np, dev, get_arch(TRAIN_ARCH), card)
    moved.append(train_example(torch, np, dev, card))
    moved.append(encode_hubert(torch, np, dev, get_arch(ENCODE_ARCH), card))
    # 11d-11g: the MoE, MLA, audio and vision families, each at full width
    # (cut in depth where its training state fits no card), then its f32
    # cut against the CPU
    for phase, arch, n_layers_, cut_layers in TRAIN_FAMILIES:
        phase_done(phase)
        base = get_arch(arch)
        cfg_ = (dataclasses.replace(base, n_layers=n_layers_) if n_layers_
                else base)
        moved.append(train_full(torch, np, dev, cfg_, card, phase))
        train_cut(torch, np, dev, base, card, n_layers=cut_layers,
                  steps=False, phase=phase)
    # 11h-11i: the recurrent families, their scans' forward and backward
    # kernels once a layer a step: rwkv6-3b whole, then its 1-layer f32 cut
    # with two train steps (as 11a); jamba's first layer (mamba + dense),
    # then that layer's f32 cut on one row (as 11d-11g)
    for (phase, arch, n_layers_, cut_layers, cut_steps,
         cut_batch) in SCAN_FAMILIES:
        phase_done(phase)
        base = get_arch(arch)
        if n_layers_:
            base = jamba_cut(base, n_layers_)
        moved.append(train_full(torch, np, dev, base, card, phase))
        train_cut(torch, np, dev, base, card, n_layers=cut_layers,
                  batch=cut_batch, steps=cut_steps, phase=phase)
    for name in ("flash_attention", "flash_attention_bwd", "norm",
                 "rwkv6_scan", "rwkv6_scan_bwd", "mamba_scan",
                 "mamba_scan_bwd"):
        launches[name] += sum(m[name] for m in moved)

    # -- 12. the distribution layer: sharded TinyBio lanes, NCCL collectives ----
    phase_done("12")
    moved = serve_sharded(torch, np, dev, card)
    launches.update({name: launches[name] + moved[name]
                     for name in TINYBIO_KERNELS})
    collective_layer(torch, np, dev, card)

    # -- 12c. the models under the sharding rules on a world-1 NCCL mesh --------
    phase_done("12c")
    moved = sharded_models(torch, np, dev, card, lm_ref)
    for name in ("flash_attention", "flash_attention_bwd", "norm",
                 "decode_attention"):
        launches[name] += moved[name]

    # -- 13. summary --------------------------------------------------------------
    phase_done()
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
