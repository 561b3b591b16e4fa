#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py                # every phase, ends with {"ok": ...}
    python3 chip_smoke.py --only matmul  # phases 1-2 and the dequant matmul
    python3 chip_smoke.py --only attention  # phases 1-2 and B1/B2
    python3 chip_smoke.py --only codec   # phases 1-2 and B3/B4
    python3 chip_smoke.py --only unpacked  # phases 1-2, B5, its round trip, B6
    python3 chip_smoke.py --only fl      # phases 1-2 and phase 9 (FL, faults)
    python3 chip_smoke.py --only families  # phases 1-2 and phase 10 (MoE, ...)
    python3 chip_smoke.py --only recurrent  # phases 1-2 and phase 11 (jamba, xLSTM)
    python3 chip_smoke.py --only frontends  # phases 1-2 and phase 12 (whisper, internvl2)
    python3 chip_smoke.py --only moe_train  # phases 1-2 and phase 13 (MoE trained)
    python3 chip_smoke.py --only examples  # phases 1-2 and phase 14 (the example twins)
    python3 chip_smoke.py --only sharded   # phases 1-2 and phase 15 (the sharded part)
    python3 chip_smoke.py --only analysis  # phases 1-2 and phase 16 (the analysis tools)
    python3 chip_smoke.py --only long     # phases 1-2 and phase 17 (long-context decode)

With ``--only matmul`` (``--only attention``, ``--only codec``, ``--only
unpacked``, ``--only fl``, ``--only families``, ``--only recurrent``,
``--only frontends``, ``--only moe_train``, ``--only examples``, ``--only
sharded``, ``--only analysis``, ``--only long``) the script runs the
device and build phases and phase 3's dequant matmul, B7/B8 (attention,
B1/B2; the packed codec, B3/B4; the unpacked codec, B5 and its round trip
and B6; phase 9; phase 10; phase 11; phase 12; phase 13; phase 14; phase
15; phase 16; phase 17), prints their
lines and
ends without the final ``{"ok": ...}`` line, so it never stands in for a
full run.

Phases (any failed check raises, so the script exits non-zero):

1. device  — card name and power limit (nvidia-smi), library versions.
2. build   — nvcc builds csrc/f2p_kernels.cu from the checkout (sm_90a).
3. kernels — each hand-written kernel at its main path's shapes against
   its plain PyTorch version ON THE CARD: the packed codec bitwise (words,
   scales, values; 6/8/16-bit formats, f32 and bf16; B4's K+V mode on a
   layer view of a stacked cache with zero, inf and NaN scales), B4's two
   modes at the unfused cache read (one layer's [1, 1024, 8, 128] cache,
   bf16 out, f2p_sr_2_8s and f2p_lr_1_6s; the K+V mode beside the two
   single calls _cache_read made before) with the host, on the device,
   with the L2 cold and as the host's enqueue time per call, B3's KV write
   (one launch for a layer's K and V into the cache) bitwise, the dump
   page included, in both addressing modes at the serving cache (8 slots,
   1024 positions over 8-token pages, 8 kv heads x 128; f2p_sr_2_8s and
   f2p_lr_1_6s) and timed per decode layer write beside the composition
   it replaced (two packed quantizes, four index_put_ scatters and the
   page arithmetic: old_paged_cache_write / old_cache_write), with the
   host, on the device and in device kernels per call, and at a prefill
   call's write and contiguous [8192, 128] rows; the unpacked codec:
   B5's table encode over all 2^32 f32 patterns against the arithmetic
   f2p_encode (code and value; f2p_sr_2_8s, f2p_sr_2_16s, f2p_lr_1_6s) and
   its pow2 reciprocal against the IEEE divide at scales 2^-126, 2^-3,
   2^127 (zero mismatches), B5/B6 bitwise at the train path's leaf shapes
   ([3072, 8192], [8192, 3072], [3072, 1024], [128256, 3072] and a [3072]
   norm; 8-bit gradient and 16-bit checkpoint formats, f32 and pow2
   scales, f32 and bf16 outputs, bf16 input), B5's round trip (one launch)
   bitwise in gradients and residuals against ef_roundtrip_plain (bf16 and
   f32 g, error feedback on and off; one leaf of each train shape, a
   ragged and a cols % 4 != 0 leaf, zero, NaN and inf blocks; NaNs by
   position), and per train step (255 leaves) B5 at 8 and 16 bits and B6
   (per leaf shape, the median of 3 timed runs with the host, and the
   device time) and the round trip, with the host and on the device, the
   round trip beside the
   composition it replaced (old_compression); attention (B1/B2: 8 rows x
   8 kv heads, G = 3, head_dim 128, kv_len 512..1024) within
   rtol=atol=1e-5 in f32 plus paged == dense-over-gathered-pages bitwise
   (also on the page table cut to the live span), the counter advance
   bitwise (state and leftover; 8/12/16-bit LI^2 and
   16-bit SR^2 cells, [4, 2^20] state, the budget of the trace's first
   2^20-packet batch, sweep0 0 and 32) and the estimate gather bitwise.
   Each is timed with CUDA events after a warm-up, beside its bound (the
   larger of bytes this call must move / 3.35 TB/s, the H100 SXM HBM3
   rate, and the f32 operations this run's data needs / 67 TFLOP/s), its
   plain version and, where one PyTorch call computes the same function, a
   yardstick the port never calls: scaled_dot_product_attention on K/V
   dequantized up front; grid_lut[state] for the estimate. B1/B2 also
   report their device time per call (torch.profiler, the kernel alone),
   a cold-L2 device time (a 64 MB write before each launch), the plan's
   splits and live CTAs and the device kernels per call, and a sha256
   digest of their outputs at the default tile over DIGEST_CASES (up to
   32768 positions, seeded on the card; attention_digest uses only what
   the wrappers took before the tile tables, so the same script run on a
   parent tree shows whether a kernel change kept these bits). Then the
   dequant matmul (B8 on f2p_sr_2_8s uint8 codes, B7 on 6- and 8-bit
   packed words) at llama3.2-3b's projection shapes (K, N) in (3072,
   3072), (3072, 1024), (3072, 8192), (8192, 3072), (3072, 128256): M = 8
   with bf16 x (the decode route) and M = 2048, a prefill chunk, with f32
   and bf16 x (the tile route, on the tensor cores); at (3072, 8192) also
   M = 16 and 128 with f32 x, and B8 on f2p_sr_2_16s uint16 codes at M =
   2048 (the f32 SIMT tile kernel, which serves the formats of more than 8
   significant bits); weights randn x 0.02 (torch.Generator seed 3; the
   prefill-sized x from seed 5) quantized on the card by quantize_weight
   and held bitwise to the plain quantizer; each call within rtol=1e-4,
   atol=1e-4 x max|y_plain| of ref_dequant_matmul; the yardstick is
   torch.matmul on the weight dequantized up front (f32, TF32 off). Each
   row names the kernel that served it (decode, mma or simt) and has the
   device time per call of the kernels alone and of torch.matmul, from
   torch.profiler over the same loop (the ms column includes the host),
   and its bound: bytes / 3.35 TB/s against f32 operations / 67 TFLOP/s
   (decode, simt) or passes x 2 M N K / 989 TFLOP/s (mma: 3 bf16 passes
   for f32 x, 1 for bf16 x). No model path calls B7/B8 (the reference's
   only caller is its benchmark folder), so their launches are those of
   one drive pass of dequant_matmul over the five shapes at M = 8, and the
   kernels line reports one decode step of the full model at M = 8 (each
   shape's time x the projections of that shape per step); beside it the
   same sum at M = 2048, one prefill chunk, with f32 and with bf16 x.
4. small   — smoke llama3.2-3b in f32 on the card (kernels) against the
   same weights on the CPU (plain versions): logits agree within 1e-3.
5. serve   — full-width llama3.2-3b (28 layers, d_model 3072, bf16, random
   weights from torch.Generator seed 0): 16 staggered requests through
   BatchedEngine(slots=8, max_seq=1024), paged, then copy-in; every request
   finishes and both modes give bitwise-equal tokens. Then a short
   Engine(fused_attention=False) run (ServeConfig's default: each decode
   step reads every layer's K and V cache back through B4's K+V mode):
   4 tokens equal to the paged run's first 4, exactly one kv_read launch
   per layer per decode step and no single-mode launch (asserted), and
   its decode ms per token ((33 tokens - 1 token) / 32, median of 3); and
   a fused sequential Engine replay whose token agreement is printed, not
   asserted (cuBLAS may sum batch-1 and batch-8 products in different
   orders at bf16). Every
   kernel's launch counter is zeroed just before the path that runs it and
   read just after; each must be > 0, and B3's KV write must launch
   exactly once per layer per decode step and per prefill call, paged and
   copy-in (its contiguous mode has no caller on the serving path). Each
   engine run prints TTFT, TBT and queue-wait p50 / p99 from the engine's
   obs registry (exact shadows and the F2P cells' estimate) and its admit
   / preempt / evict / readmit counts.
5b. policy — the same model and workload under a solved KV format: the K
   and V of all 28 layers from a prefill of the first 4 requests are
   calibrated into one state for kv/b0 (calibrate.update, NORM_SPEC, block
   = head_dim); solve picks over candidate_formats(n_bits=(6, 8)) at 6.25
   bits/elem, i.e. the lowest-error 6-bit F2P partition (asserted), and
   prints each candidate's modeled error. B3/B4 (and B3's KV write)
   bitwise and B1/B2 within 1e-5 of their plain versions at that format;
   then BatchedEngine paged and copy-in under kv_policy: bitwise-equal
   tokens, every request finished, B1/B2 and B3's KV write launched;
   tokens/s and the pool's bytes against the 8-bit run.
6. profile — torch.profiler over a short paged run (8 requests of 64
   tokens: spans of 64-81 positions): the device's busy share of the wall
   time and each kernel's device time per call, B3's KV write among them
   (the phase-3 ``ms`` times include the Python wrapper; these do not).
7. sketch  — the measurement path: a 2^25-packet Zipf-1.2 trace over 2^24
   flows (examples/sketch_zipf_trace.py's generator, numpy seed 0) streamed
   twice in odd chunks (numpy seed 1) through SketchIngestEngine(batch
   2^20, track_top 256) into a 4 x 2^20 F2PSketch of 16-bit F2P_LI^2
   cells on the card, each pass flushed. Asserts the exact packet count, a
   drained carry, the true top-10 flows among the top-20 report, each
   flow's query within 5 sd of its simulated law (|z| <= 5: 1024 draws of
   its 4 cells fed the true cell totals, min over rows), their mean
   |relative error| <= 2%, and estimates() finite with the query equal to
   its minimum over rows. Then a profiled steady window (busy
   share, B9/B10 device time per call), the device-key path (a 2^20-key
   CUDA tensor through update == the host path, bitwise, on a unit grid),
   on-arrival accuracy (512 per-arrival exact advances of 4096 8-bit cells
   against the on_arrival_mse oracle, ratio in 0.8-1.25) and an obs
   registry synced through the advance kernel (exact in the dense head).

8. train   — the serving model and the sketch are freed first.
   (a) full llama3.2-3b (28 layers, bf16, random weights from
   torch.Generator seed 0): 8 steps of make_train_step on
   data.host_batch (batch 8 x seq 128) with F2P8 gradient compression
   (the arch's default policy, min_size 512) and AdamW (lr 1e-3, warmup
   10). Asserts finite losses, exactly one launch of B5's round trip and
   no per-leaf B5 / B6 launch in every step, and at step 0 every
   compressed gradient and residual equal, bitwise, to the plain round
   trip applied on the card to the same g and r (captured by
   post-accumulate-grad hooks). Prints ms per step and tokens/s over steps
   2-7, the peak of max_memory_allocated, each step's caching-allocator
   retries, cudaMalloc / cudaFree calls and garbage-collector time (what a
   slow step spent outside its work), and, from torch.profiler over step
   1, the device's busy share and the round trip's device time per step
   (the profiler's garbage is collected before step 2).
   (b) the same trainer through launch.train.run at full width with
   depth cut to 2 layers: 2 steps, the run's AsyncCheckpointer(compress=
   True, policy=default_policy) writes step 2 into a tempfile.mkdtemp()
   directory (F2P16 payloads through B5); a fresh state restores it
   (through B6) and every compressed leaf must equal the plain codec's
   16-bit round trip bitwise, every raw leaf the saved one; then run()
   resumes from the checkpoint and takes steps 2-3 (finite losses). Prints
   the bytes on disk and the save and restore seconds; the directory is
   removed.
9. fl      — federated learning and fault injection on fl.toy_task() (the
   reference's toy LM: d_model 64, 2 layers, f32). (a) B3 (contiguous
   rows) and B5 (codes) through QT.quantize, B4 (single mode) and B6
   through QTensor.dequantize, against their plain versions on the card,
   bitwise, at the 9 compressed leaf shapes (stacked [2, ...] blocks and
   embed / lm_head): f2p_sr_2_8s and two 6-bit candidates of
   candidate_formats(n_bits=(6, 8)), f32 and pow2 scales, blocks 32 / 64 /
   128 capped at the last dim, a zero and a NaN block. (b)
   examples/fed_avg.py's three configs (4 clients, 5 rounds, 2 local
   steps, lr 0.1: f32; f2p8; packed under AutotuneConfig(every=2,
   n_bits=(6, 8), budget 6.5)) after a warm-up; asserts the example's
   acceptance (wire f32/f2p8 >= 3.5, f2p8 loss <= 1.05x f32's,
   packed-mixed >= 20% fewer bytes at <= 1.001x f2p8's loss). (c) fleet
   rounds at README's deployment (FleetConfig(n_clients=1000, sample=64,
   quorum=32), 3 rounds, client_batch 16, pow2, no error feedback):
   fault-free, chaos-small (final loss <= 1.05x fault-free), packed under
   corrupt (quarantines) and reorder + duplicates (committed parameters
   bitwise equal to fault-free's); per round the accounting, wire bytes,
   seconds and clients/s, the arrival-lag p50 / p99 from the obs
   registry; the device's busy share of one profiled round. (d) every run
   zeroes the launch counters first and asserts one B5 (B3 packed) launch
   per compressed leaf, client and round, one B6 (B4) per leaf, client and
   round for the float server and one more with error feedback, none in
   the fleet (its fold is host integer work); counts from the run's leaf
   list and cohort. (e) faults.wrap_engine over Engine on smoke
   llama3.2-3b: FaultPlan() returns the bare engine's tokens, dropout 1.0
   drops every request.
10. families — the MoE family and the other dense configs, each model
   freed before the next. (a) B1 paged and B2 dense within rtol = atol =
   1e-5 of their plain versions in f32 and paged == dense-over-gathered-
   pages bitwise, and B3's KV write bitwise in both addressing modes (and
   with all 8 slots on one dump-page position: the last writes), at the
   new configs' (kv heads, G, head_dim) = (8, 5, 128), (40, 1, 64) and
   (32, 1, 128), 8 slots x 1024 positions over 8-token pages; each timed
   with the host and on the device beside its bytes bound. (b)
   llama4-scout at full width with 8 of its 48 layers (the only cut: 48
   layers in bf16 are 215 GB), random weights from seed 0, on phase 5's
   workload: paged, copy-in and paged again, the rerun's tokens equal to
   the run's (asserted) and the paged / copy-in agreement printed (idle
   slots route like live ones and read other KV in the two modes, so the
   reference's own modes can differ there); then 8 requests of 32 tokens
   at once, every slot live throughout, paged == copy-in (asserted); the
   unfused Engine (B4's K+V read, one launch per layer per step,
   asserted); tok/s, TTFT / TBT p50 / p99, the peak of
   max_memory_allocated, the share of routed assignments capacity dropped
   in decode and in prefill (from moe_apply's load), and the device's busy
   share of a profiled paged run. The launch counters are zeroed before
   the paged run and read after the unfused Engine. (c) llama4-maverick at
   full width, 2 layers (one pattern group: a dense and a 128-expert
   layer), kv/b0 -> f2p_sr_2_8s and kv/b1 -> f2p_lr_1_6s: 4 requests x 16
   tokens on 4 slots, paged == copy-in, each position's slabs in its own
   format, the pool's bytes. (d) minicpm3-4b at full width, all 62 layers
   (MHA, head_dim 64): 8 requests x 16 tokens, paged == copy-in, tok/s.
   (e) smoke scout and maverick in f32 on the card against the CPU:
   logits within 1e-4 over prefill and 8 decode steps, greedy tokens
   equal.
11. recurrent — the mamba hybrid and xLSTM (random weights from seed 0,
   bf16). (a) B1/B2 within 1e-5 of their plain versions and bitwise to
   each other, B3's KV write bitwise, at jamba's attention shape (kv
   heads, G, head_dim) = (8, 8, 128), timed as in 10(a). Then the launch
   counters are zeroed and the main path runs: (b) xLSTM-125m, full (12
   layers, tied, no pool: the slots' caches hold only recurrent state)
   on phase 5's staggered workload through BatchedEngine(slots=8,
   max_seq=1024), twice (run == rerun, asserted), once with request 1
   preempted after round 2 (its state to the host and back: its tokens
   equal, asserted); no KV kernel launched (asserted); tok/s, TTFT / TBT,
   the recurrent state bytes per slot, the sequential Engine's agreement
   (printed) and a profiled run's busy share. (d) The train CLI's default
   arch (xlstm_125m, full) with its configs: 4 steps, batch 8 x seq 128,
   F2P8 gradients; one round-trip launch per step and no per-leaf B5 / B6
   launch (asserted), losses finite, ms per step. (c) jamba at full width
   (d 8192, 64 / 8 heads, d_ff 24576, d_inner 16384, vocab 65536, top-2)
   cut to one pattern group (8 layers) and 8 of its 16 experts, which
   the card's 80 GB force (printed): 8 requests x 32 tokens at once on 8
   slots, paged, copy-in and paged again (every slot live from the first
   decode step to the last: paged == copy-in == rerun, asserted), B3's KV
   write once per attention layer per decode step and per prefill call,
   B1 on the paged and B2 on the copy-in runs (asserted); tok/s, TTFT /
   TBT, peak memory, the decode and prefill capacity-drop shares, pool
   bytes beside the state bytes per slot and a profiled run's busy share.
   The counters are read here. (e) Smoke jamba and xLSTM in f32 on the
   card against the CPU: logits within 1e-4 over prefill and 8 decode
   steps, greedy tokens equal.
12. frontends — the two frontend archs (random weights from seed 0,
   bf16). (a) At whisper's (kv heads, G, head_dim) = (20, 1, 64) in its
   default KV format f2p_sr_1_8s (h = 1) and at internvl2's (2, 7, 64)
   (G = 7, the first odd G): B1/B2 within 1e-5 of their plain versions
   and bitwise to each other with f32 q over 8 x 1024 positions as in
   10(a), and again with bf16 q at each arch's own main-path decode (4
   rows, 448 or 384 cache positions, kv_len 5..36 or 289..320): the bf16
   output equal to the kernel's f32 output on the same q rounded, that
   within 1e-5 of the plain version, and within one bf16 rounding of the
   plain bf16 output; B3's KV write bitwise; B4's K+V read of the unfused
   decode's layer cache ([4, 448, 20, 64] or [4, 384, 2, 64], block 64)
   bitwise against kv_read_plain with bf16 and f32 out; each timed beside
   its bound. Then the main path, the launch counters zeroed just before
   each arch and read just after it: (b) whisper-large-v3 at full width
   (32 encoder and 32 decoder layers, d 1280, 2.02B parameters by the
   reference's count): 4 rows of seeded 1500-frame embeddings and a
   4-token prompt; encode once, prefill(frames=) into caches of 448
   positions (max_target_positions) in f2p_sr_1_8s, then 32 greedy
   decode_step(cross_kv=) steps three ways from that prefill: fused dense
   (B2 + B3), paged over slabs holding its pages at a permutation (B1 +
   B3; logits equal to the fused run's bitwise at every step, asserted)
   and unfused (B4 + B3; token agreement printed); every run's launches
   asserted (32 per step of its attention kernel or K+V read and of B3);
   encode ms, median step ms and tok/s over every step. (c) internvl2-1b
   at full width (24 layers): 4 rows of 256 seeded patch embeddings +
   32-token prompts, then 32 fused and 32 unfused decode steps from
   position 288 (launches asserted, 24 per step), then BatchedEngine text
   only, paged and copy-in, 8 staggered requests: tokens equal
   (asserted). After each arch's counts are read, decode_breakdown (as in
   phase 11, with the frames or patches and cross_kv) times its prefill
   and a fused decode step beside the weight-read bound and profiles it.
   (d) Both smoke configs in f32 on the card against the CPU (frames or
   patches seeded): logits within 1e-3, greedy tokens equal.
13. moe_train — the MoE family trained; the launch counters are zeroed
   before (a) and read after (c). (a) llama4-scout at full width (d 5120,
   40 / 8 heads, expert d_ff 8192, vocab 202048, top-1 + the shared
   expert, capacity 1.25, bf16, random weights from seed 0) cut to 1
   layer (its whole pattern) and 8 of its 16 experts, which the card's 80
   GB force (the train state's reckoning is printed): 6 steps of
   make_train_step with the train CLI's configs on data.host_batch (batch
   8 x seq 128). Asserts finite losses, one launch of B5's round trip and
   no per-leaf B5 / B6 launch per step, and step 0's compressed gradients
   and residuals (the 3-D expert leaves among them) bitwise equal to the
   plain round trip on g and r as autograd hands them over. Prints the
   compressed leaf count, ms per step and tokens/s over steps 2-5, the
   peak allocated beside the reckoning, step 1's device busy share and
   its split by kernel group, and each step's share of routed
   assignments that capacity dropped (from the MoE modules' load). (b)
   Smoke scout, maverick and jamba (f32; jamba's is the card's only run
   of the mamba scan's backward) trained 3 steps with the CLI's configs
   on the card and on the CPU from the same weights: losses within 1e-5
   relative, every parameter leaf after step 3 within 1e-4 relative in
   norm and its move off the shared start (the three updates) within
   1e-2, one round-trip launch per card step (asserted); after step 2
   the card's state is checkpointed as the CLI's checkpointer does (F2P16
   payloads through B5's codes mode), but from leaves of 4096 elements up
   (no smoke jamba leaf reaches the default 65536), and restored into a
   fresh state
   (B6): every compressed leaf equal to the plain codec's round trip,
   every raw leaf to the saved bits, one B5 and one B6 launch per
   compressed layer part (asserted). (c) The train forward's
   attn_impl="chunked" (chunk 48 over 128 positions) on smoke
   llama3.2-3b (f32, dense): loss within 1e-5 and every gradient leaf
   within 1e-4 in norm of naive on the card and of chunked on the CPU.
14. examples — (a) the twins' kernels at the shapes they give them,
   bitwise (B1/B2 within 1e-5) against their plain versions on the same
   inputs: B3's KV write and B4's K+V read at serve_f2p_kv's f32 [4, 48,
   4, 32] cache, B1/B2 and B3 at serve_continuous's (2 kv heads x 3 rows
   of 16, 64 positions), B9/B10 at the sketch's 4 x 4096 12-bit LI^2
   cells, B5's round trip over the quickstart's compressed f32 leaves
   and its F2P16 checkpoint codes (B5) and decode (B6); (b) the seven
   twins of examples/ (examples/torch_*.py), each
   imported by path and run through its main(argv) on the card at its
   reference example's defaults, stdout captured (the last lines logged,
   the whole report in chiprun_out/chip_smoke_examples/): the quickstart
   (the 100M model, 300 steps of 8 x 256 with F2P8 gradients and F2P16
   checkpoints into a fresh directory, then --steps 310, which must print
   "resumed from step 300" and launch B6), serve_f2p_kv, serve_continuous
   --trace (paged == copy-in == sequential and the trace asserted by the
   twin, as the reference asserts them), the sketch
   (2^20 packets twice), fed_avg and fed_avg --faults chaos-small,
   autotune_study and counters_telemetry. Each run must exit 0 and print
   its reference's acceptance line(s). The launch counts are zeroed just
   before each run and read just after it; over the phase B1-B6 and B9
   must have launched. No example reaches B7/B8 (the reference's only
   caller is its benchmark folder) or B10 (both sketches' query gathers
   grid values itself; only F2PSketch.estimates() launches B10).
15. sharded — the sharded part (A12) on one card, ranks as processes that
   share it over gloo (NCCL refuses two ranks on one device; gloo moves
   CPU tensors, so each collective's leg is staged through host memory,
   by design, and named on a line). (a) compressed_psum on 2 ranks at
   llama3.2-3b's down gradient [8192, 3072] and xLSTM-125m's embedding
   [50304, 768], f32, unpacked and packed: each rank's B5 (B3) launch on
   its sum shard and the gathered B6 (B4) bitwise against the plain
   versions on the card, the result the plain composition's bits, packed
   == unpacked, and within the codec's bound of the f32 mean; (b) ``python
   -m repro_torch.launch.train --arch xlstm_125m --full --mesh-shape 2,2``
   (4 ranks on the card, the model axis split, the launcher's defaults, a
   checkpoint every step) killed by --die-at-step 3 (rc 42), its 3 losses
   before the kill against a 1,1 run's (in the whole script, phase
   11(d)'s: the same arch, configs and data), then restarted on 2,1,
   which must resume from the latest committed step; the ranks' state
   bytes, peak memory, step time and model-axis split from the CLI's
   "ranks" line; (c) llama3.2-3b at full width, 3 steps on a (1,1) NCCL
   DeviceMesh (DTensor state, the sharded step, one B5 round trip a step
   on the local shards), its losses held to the plain path's: phase 8's
   first 3 (the same seed, configs and batches; ``--only sharded`` trains
   the plain path itself);
   (d) phase 7's sketch (4 x 2^20 16-bit cells) on 2 ranks of 2 rows
   each, 2^22 packets as device batches, flushed and estimated: each
   rank's B9 with its lane base bitwise against the plain version, the
   gathered state bitwise the unsharded sketch's on the card, B9 and B10
   launches per rank; (e) model-axis parallel training on a (1, 2) mesh,
   2 ranks sharing the card over gloo, ``make_train_step`` on the state
   ``init_train_state`` places: llama3.2-3b at full width and
   scout (1 layer, 8 of 16 experts: phase 13's cut), 3 steps of 8 x 128
   each, every rank computing its vocabulary rows, heads, FF width and
   experts; losses held to the one-process run's (phase 8's and phase
   13's first 3, or a plain run here under ``--only sharded``), per-rank
   state about half the one-process state, peak memory, ms a step, the
   bytes of each named leg, one B5 round trip a step on each rank's local
   shards.
16. analysis — the launch analysis tools (A14). (a) The op analysis
   (launch/op_analysis.py; kernels charged through kernels/cost.py) of
   full-width llama3.2-3b's train step (phase 8's 8 x 128) and of a decode
   step of 8 slots over packed caches of 1024 positions (fused attention,
   position 512), each on the card and again on fake CPU tensors: FLOPs
   equal, bytes within 1%, and the step as measured (CUDA events after a
   synchronize) at least 0.9 x max(t_compute, t_memory) at the H100's
   data-sheet rates (launch/roofline.py); (b) ``python -m
   repro_torch.launch.dryrun`` of llama3.2-3b decode_32k and train_4k on
   the single-pod fake world (one CPU process each, run beside (a)),
   ``launch.report`` over the two records, one ``launch.hillclimb`` variant
   at decode; the seconds each cell traced. Records and the report land in
   chiprun_out/analysis/.
17. long   — long-context decode (caches past 32768 positions) and the
   tile tables. (a) B1 (a shuffled page table) and B2 (dense, the gathered
   pages) at batch 1 over caches of 32896, 131072 and 524288 positions, at
   llama3.2-3b's and jamba's (kv heads, G, head_dim) = (8, 3, 128) and (8,
   8, 128), f2p_sr_2_8s, kv_len S - 1 and 100, tiles 128 and 512: paged ==
   dense and the page table cut to the live span == the dense call on the
   full cache, bitwise; within rtol = atol = 1e-5 of the plain version at
   the same tile; at kv_len S - 1 the ms with the host, device ms, the
   bound and SDPA (enable_gqa, bf16 K/V of the live positions). Then the
   launch counters are zeroed and the main path runs: (b) full-width
   llama3.2-3b's paged and copy-in BatchedEngine and sequential Engine,
   each built with max_seq 131072, on 3 requests of 64 tokens (16 new),
   one slot: tokens paged == copy-in == sequential (asserted); (c) one
   llama3.2-3b row: a 131072-position cache filled through B3 from seeded
   K/V, the same words as pool slabs at a permutation, 8 greedy steps from
   position 131064 dense (B2) and paged (B1), logits bitwise equal at
   every step; (d) the reference's long_500k cell for jamba, cut as in
   phase 11 (8 layers, 8 of 16 experts): caches of 524288 positions
   filled the same way, 4 steps ending at position 524287, paged == dense
   logits bitwise; the counters are read (B1, B2 and B3 must have
   launched). (e) autotune_attention_tile("cuda", 8) and
   autotune_matmul_tiles("cuda", 6 and 8) at their default shapes, each
   candidate also timed with CUDA events, the kernel at the winner held to
   its plain version; then both tables are cleared.

Prints one ``{"sketch": {...}}`` JSON line, one ``{"train": {...}}`` JSON
line, one ``{"fl": {...}}`` JSON line, one ``{"families": {...}}`` JSON
line, one ``{"recurrent": {...}}`` JSON line, one ``{"frontends":
{...}}`` JSON line, one ``{"moe_train": {...}}`` JSON line, one ``{"examples":
{...}}`` JSON line, one ``{"sharded": {...}}`` JSON line, one
``{"analysis": {...}}`` JSON line, one ``{"long": {...}}`` JSON line, one
``{"kernels": [...]}``
JSON line (all ten kernels and B5's round-trip mode, ``ef_roundtrip``, as
a row of its own; B5's codes mode and B6 count the launches of phase 8's
checkpoint save and restore; B3-B6 also carry ``fl_launches``, phase 9's,
B1-B4 ``families_launches``, phase 10's, and B1-B3 and the round trip
``recurrent_launches``, phase 11's, B1-B4 ``frontends_launches``, phase
12's, B5's codes mode, its round trip and B6 ``moe_train_launches``,
phase 13's, every kernel ``examples_launches``, phase 14's, and B3-B6,
the round trip, B9 and B10 ``sharded_launches``, phase 15's, and B1-B3
``long_launches``, phase 17's), then the nvidia-smi line, then the last
line ``{"ok": true, "device": {...}}``. A line before them gives each
phase's seconds. A copy of the results goes to chiprun_out/chip_smoke.json.
"""
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
SRC = "src/repro_torch/csrc/f2p_kernels.cu"
REPLACES = {
    "quantize_packed": "src/repro/kernels/f2p_quant.py:341",
    "dequantize_packed": "src/repro/kernels/f2p_quant.py:352",
    "quantize": "src/repro/kernels/f2p_quant.py:186",
    "ef_roundtrip": "src/repro/kernels/f2p_quant.py:186",
    "dequantize": "src/repro/kernels/f2p_quant.py:197",
    "attention_packed": "src/repro/kernels/f2p_attention.py:183",
    "attention_paged": "src/repro/kernels/f2p_attention.py:385",
    "counter_advance": "src/repro/kernels/f2p_counter.py:177",
    "counter_estimate": "src/repro/kernels/f2p_counter.py:267",
    "dequant_matmul": "src/repro/kernels/f2p_matmul.py:90",
    "dequant_matmul_packed": "src/repro/kernels/f2p_matmul.py:147",
}
# phase 3: llama3.2-3b's projections as (K, N): q and o, k and v, gate and
# up, down, the LM head
MATMUL_SHAPES = ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072),
                 (3072, 128256))
# phase 5b: the KV-format solve (a 6-bit code and an f32 scale per 128)
KV_CANDIDATE_BITS, KV_BUDGET_BITS = (6, 8), 6.25
# phase 7: the sketch of a monitoring host counting a backbone link
SKETCH = dict(depth=4, width=1 << 20, n_bits=16, h_bits=2, flavor="li",
              seed=0)
N_PACKETS, N_FLOWS, BATCH = 1 << 25, 1 << 24, 1 << 20
# phase 3: the exhaustive check of B5's table encode
ENC_CHECK_FORMATS = ("f2p_sr_2_8s", "f2p_sr_2_16s", "f2p_lr_1_6s")
POW2_CHECK_SCALES = (2.0 ** -126, 2.0 ** -3, 2.0 ** 127)
# phase 8: the train path of launch/train.py's defaults
ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "llama3_2_3b", 8, 8, 128
# phase 10: (kv heads, query rows per kv head G, head_dim) the new configs
# give B1-B3 (scout and maverick 40 / 8 heads; minicpm3, MHA at head_dim 64;
# codeqwen, MHA), and the depth each full-width MoE model is cut to: 48
# scout layers in bf16 are 215 GB, 2 maverick layers (one pattern group, a
# dense and a 128-expert layer) are 37 GB, against the card's 80
FAMILY_SHAPES = ((8, 5, 128), (40, 1, 64), (32, 1, 128))
SCOUT_LAYERS, MAVERICK_LAYERS = 8, 2
# phase 11: jamba's attention shape for B1-B3 (8 kv heads, 64 / 8 = 8 query
# rows each, head_dim 128); jamba cut to one pattern group of 8 layers and 8
# of its 16 experts (one group with 16 is 90.2 GB in bf16, with 8 51.6 GB,
# against the card's 80); the train CLI's default arch, 4 steps
RECURRENT_SHAPE = (8, 8, 128)
JAMBA_LAYERS, JAMBA_EXPERTS = 8, 8
XLSTM_TRAIN_STEPS = 4
# phase 12: whisper's rows, prompt and caches of 448 positions
# (max_target_positions of the public whisper-large-v3 config); internvl2's
# rows, patch embeddings, prompt tokens after them, and caches; decode steps
# of each run
WHISPER_ROWS, WHISPER_PROMPT, WHISPER_MAX_SEQ = 4, 4, 448
VLM_ROWS, VLM_PATCHES, VLM_PROMPT, VLM_MAX_SEQ = 4, 256, 32, 384
FRONTEND_STEPS = 32
# (kv heads, G, head_dim, KV format, main-path rows, cache positions, first
# decode position) of whisper's decoder self-attention (20 heads = MHA, its
# default policy's kv/* format) and internvl2's (14 query over 2 kv heads)
FRONTEND_SHAPES = (
    (20, 1, 64, "f2p_sr_1_8s", WHISPER_ROWS, WHISPER_MAX_SEQ, WHISPER_PROMPT),
    (2, 7, 64, "f2p_sr_2_8s", VLM_ROWS, VLM_MAX_SEQ,
     VLM_PATCHES + VLM_PROMPT))
# phase 13: the MoE family trained; scout at full width cut to 1 layer (its
# whole pattern) and 8 of its 16 experts: the port's train state is 16 bytes
# a parameter (bf16 parameter and gradient, f32 mu, nu and error-feedback
# residual), 52.2 GB at 3.26B parameters, plus AdamW's f32 temporaries on
# the [202048, 5120] embedding; with 16 experts it is 68.3 GB and those
# temporaries push it past the card's 80
MOE_ARCHS = ("llama4_scout_17b", "llama4_maverick_400b", "jamba_1_5_large")
MOE_TRAIN_EXPERTS, MOE_TRAIN_STEPS, MOE_SMOKE_STEPS = 8, 6, 3
# the smoke checkpoints' min_size: at the checkpointer's default (65536) no
# leaf of smoke jamba's state is large enough (8 positions of one group each)
MOE_SMOKE_CKPT_MIN_SIZE = 4096
# 13(b)'s limits, card against CPU: the losses (1.53e-7 apart on an H100),
# every leaf after the last step and its move off the start, in norm. The
# CPU alone, at 1 against 4 threads, moves a leaf by up to 1.2e-5 and its
# move by up to 4.3e-4 (near-zero gradients flip AdamW's first-step sign,
# F2P8 codes land on neighbours); a wrong gradient moves a leaf's move O(1)
MOE_SMOKE_LOSS_TOL, MOE_SMOKE_LEAF_TOL, MOE_SMOKE_MOVE_TOL = 1e-5, 1e-4, 1e-2
# 13(c): the chunk (it does not divide TRAIN_SEQ) and the limits of the
# chunked train forward's loss and gradients (f32, in norm)
MOE_CHUNK, MOE_CHUNK_LOSS_TOL, MOE_CHUNK_GRAD_TOL = 48, 1e-5, 1e-4
# phase 9: federated learning, examples/fed_avg.py's defaults and README's
# fleet deployment; the FL leaf shapes' formats (a 6-bit candidate of
# candidate_formats(n_bits=(6, 8)) beside the 8-bit wire format) and blocks
FL_FORMATS = ("f2p_sr_2_8s", "f2p_sr_1_6s", "f2p_lr_1_6s")
FL_BLOCKS = (32, 64, 128)
FL_FEDAVG = dict(n_clients=4, rounds=5, local_steps=2, lr=0.1,
                 packed_budget=6.5)
FL_FLEET = dict(n_clients=1000, sample=64, quorum=32, rounds=3,
                client_batch=16)
# phase 14: the twins of examples/ (examples/torch_*.py), each through its
# main(argv) at its reference example's defaults on the card, with the line
# its reference's acceptance prints; the quickstart runs twice into one
# fresh directory, the second run past the first's last step
QUICKSTART_STEPS, QUICKSTART_RESUMED = 300, 310
EXAMPLE_RUNS = (
    ("quickstart", "torch_quickstart",
     ["--steps", str(QUICKSTART_STEPS)], ("done.",)),
    ("quickstart_resume", "torch_quickstart",
     ["--steps", str(QUICKSTART_RESUMED)],
     (f"resumed from step {QUICKSTART_STEPS}", "done.")),
    ("serve_f2p_kv", "torch_serve_f2p_kv", [],
     ("cache=0.79 MB", "cache=0.22 MB", "token agreement exact-vs-F2P8")),
    ("serve_continuous", "torch_serve_continuous", ["--trace"],
     ("bit-for-bit identical to the copy-in engine AND the sequential "
      "engine", "trace OK")),
    ("sketch_zipf_trace", "torch_sketch_zipf_trace", [],
     ("top-10 recall: 100%",)),
    ("fed_avg", "torch_fed_avg", [],
     ("acceptance (>=3.5x wire, <=1.05x loss): PASS",
      "acceptance (packed: >=20% wire drop, <=1.001x f2p8 loss): PASS")),
    ("fed_avg_chaos", "torch_fed_avg", ["--faults", "chaos-small"],
     ("acceptance (<=1.05x fault-free loss, finite model): PASS",)),
    ("autotune_study", "torch_autotune_study", [], ("overall: PASS",)),
    ("counters_telemetry", "torch_counters_telemetry", [],
     ("mean rel err:", "load imbalance (max/mean):")),
)
# phase 15: the sharded part. (a) compressed_psum's two full-width leaves
# (llama3.2-3b's down gradient, xLSTM-125m's embedding), (b) the train CLI
# at --mesh-shape 2,2, a checkpoint every step, killed at SHARD_DIE_AT (the
# asynchronous writer commits step 1 or 2 before the kill at the top of
# step 3) and restarted on 2,1, its
# losses before the kill against 1,1: step 0's within SHARD_LOSS0_RTOL (the
# same parameters; bf16 activations of half-batch GEMMs round otherwise),
# the others within SHARD_LOSS_RTOL (each data rank's bf16 gradient
# rounded, summed in f32 and rounded again, and AdamW's first steps turn the
# rounding of near-zero gradients into +-lr moves: 1.9e-3 after 6 steps and
# 3.1e-3 after 4 on an H100; on the CPU in f32,
# tests/test_torch_sharded_train.py holds the same step to 1e-5), (c)
# llama3.2-3b on a (1,1) mesh, SHARD_LLAMA_STEPS steps, losses against the
# plain path within SHARD_MESH_RTOL (a world of one: the same leaves in the
# same order; bitwise on the CPU), (d) phase 7's sketch on 2 ranks
SHARD_PSUM_LEAVES = (("llama_down_grad", (8192, 3072)),
                     ("xlstm_embed", (50304, 768)))
SHARD_XLSTM_STEPS, SHARD_DIE_AT = 4, 3
SHARD_LOSS0_RTOL, SHARD_LOSS_RTOL, SHARD_MESH_RTOL = 1e-4, 1e-2, 1e-6
SHARD_LLAMA_STEPS, SHARD_PACKETS = 3, 1 << 22
# (e) model-axis parallel training at (1, 2): SHARD_TP_STEPS steps, losses
# against the one-process run's: step 0 within SHARD_TP_LOSS0_RTOL (the
# same parameters; a split layer's bf16 partial products are rounded, summed
# in f32 and rounded again, where one bf16 product rounds once), the rest
# within SHARD_TP_LOSS_RTOL (those roundings move the bf16 gradients, and
# AdamW's first steps turn the rounding of near-zero gradients into +-lr
# moves, as in (b)); each rank's state within SHARD_TP_STATE_SHARE of half
# the one-process state (the norms and the router are whole on each rank)
SHARD_TP_STEPS, SHARD_TP_LOSS0_RTOL, SHARD_TP_LOSS_RTOL = 3, 1e-3, 1e-2
SHARD_TP_STATE_SHARE = (0.45, 0.55)
# step 0's gradient norm (the same parameters and batch) within this of the
# one-process run's: only the bf16 roundings of the partial sums differ
SHARD_TP_GNORM0_RTOL = 1e-3
# what no example reaches: B7/B8 (the dequant matmul; the reference's only
# caller is its benchmark folder) and B10 (the estimate table: the sketch's
# query gathers grid_lut[state[rows, idx]] itself, as the reference's does,
# and only F2PSketch.estimates() launches B10)
EXAMPLES_UNREACHED = ("dequant_matmul", "dequant_matmul_packed",
                      "counter_estimate")
# f32 operations of one live sweep of the advance (min, sub, log, div,
# ceil, two compares, max, compare, sub), log and divide counted as one
ADVANCE_OPS_PER_SWEEP = 10
# phase 17: long-context decode. (a) B1/B2 at batch 1 over caches of 32896
# positions (257 splits of 128), 131072 (Llama 3.2's published context) and
# 524288 (the reference's long_500k shape, launch/dryrun.py), at
# llama3.2-3b's (kv heads, G, head_dim) and jamba's, tiles 128 and 512;
# (b) llama3.2-3b's engines built with max_seq LONG_MAX_SEQ on
# LONG_REQUESTS requests of LONG_PROMPT tokens (a prefill bucket) and
# LONG_NEW new ones; (c) LONG_STEPS decode steps ending at the last
# position of a full LONG_MAX_SEQ cache; (d) jamba cut as in phase 11 at
# long_500k: JAMBA_LONG_STEPS steps ending at position 524287
LONG_LENGTHS = (32896, 131072, 524288)
LONG_SHAPES = ((8, 3, 128), (8, 8, 128))
LONG_TILES = (128, 512)
LONG_MAX_SEQ, LONG_REQUESTS, LONG_PROMPT, LONG_NEW = 131072, 3, 64, 16
LONG_STEPS = 8
JAMBA_LONG_S, JAMBA_LONG_STEPS = 524288, 4


def log(*a):
    print(*a, flush=True)


def gc_cuda() -> None:
    """Collect the garbage and hand the card's cached blocks back, so the
    next model of a phase finds the memory its predecessor held."""
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=30, warm=3) -> float:
    import torch

    for _ in range(warm):
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


def host_ms(fn, iters=20, repeats=3) -> float:
    """The median of ``repeats`` runs of :func:`cuda_ms`: for calls of a
    few µs, one host stall (the collector, the OS) inside a single run
    would otherwise stand for every call of a shape."""
    import statistics

    return statistics.median(cuda_ms(fn, iters=iters)
                             for _ in range(repeats))


def _device_events(fn, iters, flush=None):
    """(name, duration in us) of every device event of ``iters`` calls of
    ``fn`` under torch.profiler (``flush`` runs before each call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.end - e.time_range.start)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms_kernels(fn, iters=20, tries=3):
    """(device time per call of everything ``fn`` launches, device kernels
    per call): kernels only, no host time, from torch.profiler over
    ``iters`` calls after a warm-up, in ``tries`` profiled runs. The
    profiler can drop device events: a run counts only if it kept ``iters``
    times the events of one call (the most per call that any run kept).
    (None, None) (not measured) where no run kept them all, or where the
    profiler saw no device activity."""
    import torch

    fn()
    torch.cuda.synchronize()
    runs = [_device_events(fn, iters) for _ in range(tries)]
    per_call = max(len(ev) // iters for ev in runs)
    for ev in runs:
        if per_call and len(ev) == iters * per_call:
            return sum(d for _, d in ev) / iters / 1e3, per_call
    log(f"device   : the profiler kept {[len(ev) for ev in runs]} device "
        f"events of {iters} calls; device time not measured")
    return None, None


def device_ms(fn, iters=20, tries=3):
    """Device time per call of everything ``fn`` launches (see
    :func:`device_ms_kernels`); None where not measured."""
    return device_ms_kernels(fn, iters, tries)[0]


def device_calls(fn, name: str, iters=20, flush=None, tries=3):
    """(device ms per call of the kernels whose name contains ``name``,
    device kernels per call of everything ``fn`` launches), after a
    warm-up; with ``flush`` (a callable that evicts the L2, one kernel),
    flush before each call, so each launch finds its inputs in device
    memory. The profiler can drop device events: the kernels per call come
    from a run that kept one ``name`` kernel per call (up to ``tries``
    runs), else None; the time is the mean of the launches a run kept, if
    it kept at least half. (None, None) where none did."""
    import torch

    fn()
    torch.cuda.synchronize()
    kept = []
    for _ in range(tries):
        ev = _device_events(fn, iters, flush)
        ours = [d for n, d in ev if name in n]
        if len(ours) == iters:
            return (sum(ours) / iters / 1e3,
                    (len(ev) - (iters if flush is not None else 0)) / iters)
        kept = max(kept, ours, key=len)
    log(f"device   : the profiler kept at most {len(kept)} of {iters} "
        f"{name} launches")
    if 2 * len(kept) >= iters:
        return sum(kept) / len(kept) / 1e3, None
    return None, None


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def make_trace(n_packets: int, n_flows: int, seed: int = 0):
    """examples/sketch_zipf_trace.py's packet trace: Zipf-1.2 ranks
    scrambled onto flow ids."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ranks = rng.zipf(1.2, size=n_packets)
    return (ranks.astype(np.int64) * 0x9E3779B1) % n_flows


def device_profile(prof, wall_us: float, names) -> dict:
    """Busy share of the wall time and device time per call of the kernels
    whose names contain one of ``names``, from a torch.profiler run."""
    from torch.autograd import DeviceType

    dev = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, cur = 0.0, None
    for _, s, e in sorted(dev, key=lambda x: x[1]):
        if cur is None or s > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    per = {}
    for name, s, e in dev:
        n, tot = per.get(name, (0, 0.0))
        per[name] = (n + 1, tot + (e - s))
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:8]
    ours = {k: dict(calls=n, device_ms_per_call=tot / n / 1e3)
            for k, (n, tot) in per.items() if any(m in k for m in names)}
    groups: dict = {}
    for k, (n, tot) in per.items():
        g = kernel_group(k, names)
        groups[g] = groups.get(g, 0.0) + tot / 1e3
    # the host side: the ops of most self CPU time, and the calls that wait
    # for the device (a host that waits cannot run ahead of it)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    waits = {e.key: e.count for e in host if e.key in HOST_WAITS}
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                device_busy_share=busy / wall_us if dev else None,
                kernels=ours, groups_ms=groups,
                top=[dict(name=k[:80], calls=n, device_ms=tot / 1e3)
                     for k, (n, tot) in top],
                host_top=[dict(name=e.key[:60], calls=e.count,
                               self_cpu_ms=e.self_cpu_time_total / 1e3)
                          for e in host[:10]],
                host_waits=waits)


# host calls that wait for the device
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "aten::_local_scalar_dense",
              "aten::item", "cudaMemcpy")


def kernel_group(name: str, ours) -> str:
    """A device kernel's group for the time breakdown: the port's own
    kernels, matrix products (cuBLAS / CUTLASS), elementwise, reductions,
    copies, other."""
    low = name.lower()
    if any(m in name for m in ours):
        return "ours"
    if any(m in low for m in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul"
    if "memcpy" in low or "copy" in low:
        return "copy"
    if "reduce" in low or "norm" in low or "softmax" in low:
        return "reduction"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def log_profile(tag: str, res: dict) -> None:
    if res["device_busy_share"] is None:
        log(f"profile  : {tag}: the profiler saw no device activity: "
            "not measured")
        return
    log(f"profile  : {tag}: wall {res['wall_ms']:.1f} ms, device busy "
        f"{res['device_busy_ms']:.1f} ms "
        f"({100 * res['device_busy_share']:.1f}%)")
    for k, v in res["kernels"].items():
        log(f"profile  :   {k[:60]}: {v['calls']} calls, "
            f"{v['device_ms_per_call']:.5f} ms device per call")
    log("profile  :   by group (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(res["groups_ms"].items(),
                                          key=lambda kv: -kv[1])))
    for t in res["top"]:
        log(f"profile  :   top {t['device_ms']:9.3f} ms {t['calls']:6d} x "
            f"{t['name']}")
    for t in res.get("host_top", ()):
        log(f"profile  :   host {t['self_cpu_ms']:9.3f} ms {t['calls']:6d} x "
            f"{t['name']}")
    log(f"profile  :   host waits on the device: {res.get('host_waits')}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions on the card
# ---------------------------------------------------------------------------
def codec_bitwise(dev, g, fmt) -> None:
    """B3 and B4 against their plain versions, bitwise, at the serving
    shapes: decode (slots 8 x 8 kv heads rows of head_dim 128) and a
    prefill group (4 prompts at bucket 256 x 8 kv heads); B4's K+V mode on
    a layer of the unfused engine's cache (layer 1 of 2 x [1, 1024, 8,
    128]), with zero, inf and NaN scales."""
    import torch

    from repro_torch.kernels import f2p_quant as Q

    for rows, dt in ((64, torch.bfloat16), (64, torch.float32),
                     (8192, torch.bfloat16)):
        x = (torch.randn(rows, 128, generator=g, device=dev) * 3).to(dt)
        x[0, :32] = 0
        x[1] = 0
        w, s = Q.f2p_quantize_packed(x, fmt)
        pw, ps = Q.quantize_packed_plain(x, fmt, 128)
        assert torch.equal(w.view(torch.int32), pw.view(torch.int32)), \
            f"quantize words differ: {fmt} {rows} {dt}"
        assert torch.equal(s, ps), f"quantize scales differ: {fmt}"
        for odt in (torch.float32, torch.bfloat16):
            d = Q.f2p_dequantize_packed(w, s, fmt, out_dtype=odt)
            pd = Q.dequantize_packed_plain(w, s, fmt, 128, odt)
            assert torch.equal(d, pd), f"dequantize differs: {fmt} {odt}"
    cache = kv_read_cache(dev, g, fmt)
    for kv in ("k", "v"):
        sc = cache[kv].scales.view(-1)
        sc[:3] = torch.tensor([0.0, float("inf"), float("nan")], device=dev)
    for odt in (torch.float32, torch.bfloat16):
        got = Q.f2p_kv_read(cache, odt)
        for a, b in zip(got, Q.kv_read_plain(cache, odt)):
            assert torch.equal(_bits(a), _bits(b)), f"kv_read differs: {fmt} {odt}"


def kv_read_cache(dev, g, fmt, L=2, layer=1, B=1, S=1024, K=8, hd=128):
    """Layer ``layer`` of an L-stacked packed cache [L, B, S, K, hd] (the
    unfused engine's layout: a layer view at an offset into the stack),
    every position written from randn x 3."""
    import torch

    from repro_torch.core import qtensor as QT

    stack = {kv: QT.quantize(torch.randn(L, B, S, K, hd, generator=g,
                                         device=dev) * 3, fmt, block=hd,
                             packed=True) for kv in ("k", "v")}
    return {kv: QT.QTensor(c.codes[layer], c.scales[layer], c.fmt, c.block,
                           c.shape[1:], True) for kv, c in stack.items()}


def host_enqueue_ms(fn, iters=200) -> float:
    """Host time per call: ``iters`` calls enqueued without a sync (the
    device runs behind), from the host's clock."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / iters * 1e3


def check_codec(dev):
    """B3 and B4: the codec bitwise at the serving shapes (6/8/16-bit,
    contiguous rows, B4's K+V mode on a layer view), B3's KV write bitwise
    and timed (check_kv_write), the prefill quantize timed, and B4's two
    modes at the unfused cache read (check_dequantize)."""
    import torch

    from repro_torch.core.formats import named_format
    from repro_torch.kernels import cost
    from repro_torch.kernels import f2p_quant as Q

    g = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for name in ("f2p_sr_2_6s", "f2p_sr_2_8s", "f2p_lr_2_16s"):
        codec_bitwise(dev, g, named_format(name))
    log("codec    : quantize/dequantize kernels == plain, bitwise "
        "(6/8/16-bit, f32+bf16 in, f32+bf16 out; B4's K+V read of a layer "
        "view with zero/inf/NaN scales)")
    fmt = named_format("f2p_sr_2_8s")
    out["quantize_packed"] = check_kv_write(dev)
    # B3's contiguous mode at a prefill group's rows (4 prompts x 256
    # positions x 8 kv heads), beside its bytes bound
    xp = torch.randn(8192, 128, generator=g, device=dev).to(torch.bfloat16)
    pf = dict(ms=cuda_ms(lambda: Q.f2p_quantize_packed(xp, fmt), iters=100),
              device_ms=device_ms(lambda: Q.f2p_quantize_packed(xp, fmt)),
              bound_ms=bound_ms(cost.nbytes("quantize_packed", xp, fmt)))
    out["quantize_packed"]["prefill_quantize"] = pf
    log(f"quantize : contiguous rows [8192,128] bf16 {pf['ms']:.5f} ms "
        f"(device {_ms(pf['device_ms'])}; bound {pf['bound_ms']:.5f} ms)")
    out["dequantize_packed"] = check_dequantize(dev, g)
    return out


def check_dequantize(dev, g, names=("f2p_sr_2_8s", "f2p_lr_1_6s")) -> dict:
    """B4's two modes at the Engine(fused_attention=False) cache read, one
    layer's [1, 1024, 8, 128] cache, bf16 out: the single mode on its K
    words [8192, W] and the K+V mode (f2p_kv_read) on the layer view, each
    timed with the host (CUDA events around a loop), on the device
    (torch.profiler, the kernel alone, L2-resident as in that loop), with
    the L2 cold (a 64 MB write before each launch: a layer's cache is read
    once per decode step, after 27 other layers' work), the host's enqueue
    time per call, beside the bytes bound, the plain version and, for the
    K+V mode, the two single calls that _cache_read made before; per format
    (8-bit and 5b's solved 6-bit)."""
    import torch

    from repro_torch.core import qtensor as QT
    from repro_torch.core.formats import named_format
    from repro_torch.kernels import cost
    from repro_torch.kernels import f2p_quant as Q

    bf = torch.bfloat16
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    for name in names:
        fmt = named_format(name)
        cache = kv_read_cache(dev, g, fmt)
        ck, cv = cache["k"], cache["v"]
        w = ck.codes.reshape(-1, ck.codes.shape[-1])
        s = ck.scales.reshape(-1, 1)
        single = lambda: Q.f2p_dequantize_packed(w, s, fmt, out_dtype=bf)
        both = lambda: Q.f2p_kv_read(cache, bf)
        for mode, fn, plain, nb, old in (
                ("single", single,
                 lambda: Q.dequantize_packed_plain(w, s, fmt, 128, bf),
                 cost.nbytes("dequantize_packed", w, s, fmt, out_dtype=bf),
                 None),
                ("kv_read", both, lambda: Q.kv_read_plain(cache, bf),
                 cost.nbytes("kv_read", cache, bf), lambda: (QT.dequantize(ck, dtype=bf),
                                    QT.dequantize(cv, dtype=bf)))):
            got, ref = fn(), plain()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
                f"B4 {mode} differs from its plain version: {name}"
            dms, per_call = device_calls(fn, "dequantize_packed_kernel")
            cold, _ = device_calls(fn, "dequantize_packed_kernel",
                                   flush=scratch.zero_)
            r = dict(ms=host_ms(fn, iters=100), device_ms=dms, cold_ms=cold,
                     host_enqueue_ms=host_enqueue_ms(fn),
                     device_kernels_per_call=per_call,
                     plain_ms=cuda_ms(plain, iters=10), bound_ms=bound_ms(nb),
                     bound_by="bytes", library_ms=None, max_abs_err=max(
                         float((a.float() - b.float()).abs().max())
                         for a, b in zip(got, ref)))
            if old is not None:
                r["two_single_ms"] = host_ms(old, iters=100)
                r["two_single_device_ms"], r["two_single_kernels"] = \
                    device_ms_kernels(old)
            rows[f"{name} {mode}"] = r
            log(f"dequant  : {name:12s} {mode:7s} {r['ms']:.5f} ms (device "
                f"{_ms(dms)}, cold L2 {_ms(cold)}, host enqueue "
                f"{r['host_enqueue_ms']:.5f}; {per_call} device kernels per "
                f"call) bound {r['bound_ms']:.5f}, plain {r['plain_ms']:.3f}"
                + ("" if old is None else
                   f"; _cache_read's two single calls {r['two_single_ms']:.5f}"
                   f" ms (device {_ms(r['two_single_device_ms'])}, "
                   f"{r['two_single_kernels']} kernels)"))
    del scratch
    main = dict(rows[f"{names[0]} kv_read"])
    main.update(rows=rows, shape=f"one layer's K and V cache [1, 1024, 8, "
                f"128] ({names[0]}, a layer view of the stack) -> bf16, one "
                f"launch")
    return main


# the serving cache: 8 slots, max_seq 1024 over 8-token pages, 8 kv heads
# of head_dim 128; the paged pool holds (slots + 1) x 128 pages + the dump
KV_SLOTS, KV_MAX_SEQ, KV_PAGE, KV_HEADS, KV_HD = 8, 1024, 8, 8, 128


def kv_write_inputs(dev, g, fmt, paged: bool, B=KV_SLOTS, S=1,
                    dtype="bf16", K=KV_HEADS, hd=KV_HD, max_seq=KV_MAX_SEQ):
    """(cache, k, v, pos, pages) of one layer's KV write at the serving
    cache: a paged pool (page table of random distinct pages; the last two
    slots retired onto the dump page 0) or a dense [B, max_seq] cache; k, v
    [B, S, K, hd] (8 x 128 by default) randn x 3; pos [B] int64 in [0,
    max_seq - S]."""
    import torch

    from repro_torch.models.attention import empty_packed

    maxp = max_seq // KV_PAGE
    P = (KV_SLOTS + 1) * maxp + 1
    lead = (P, KV_PAGE) if paged else (B, max_seq)
    cache = {kv: empty_packed((*lead, K, hd), fmt, dev)
             for kv in ("k", "v")}
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    k, v = ((torch.randn(B, S, K, hd, generator=g, device=dev)
             * 3).to(dt) for _ in range(2))
    pos = torch.randint(0, max_seq - S + 1, (B,), generator=g, device=dev)
    pages = None
    if paged:
        pages = (1 + torch.randperm(P - 1, generator=g, device=dev)[
            :B * maxp]).reshape(B, maxp).to(torch.int32)
        pages[-2:] = 0
    return cache, k, v, pos, pages


def _clone_cache(cache):
    from repro_torch.core.qtensor import QTensor

    return {kv: QTensor(c.codes.clone(), c.scales.clone(), c.fmt, c.block,
                        c.shape, True) for kv, c in cache.items()}


def old_paged_cache_write(cache, k, v, pos, pages):
    """The composition B3's KV write replaced in the paged decode write
    (models/attention.py before the fused write): the page arithmetic, then
    for K and V a packed quantize (B3's contiguous mode) and two
    ``index_put_`` scatters."""
    import torch

    from repro_torch.models.attention import quantize_kv

    T = cache["k"].codes.shape[1]
    B = pages.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=pages.device)
    pos = pos.expand(B)
    col = torch.clamp(pos // T, max=pages.shape[1] - 1)
    pidx = pages[torch.arange(B, device=pages.device), col].to(torch.int64)
    off = pos % T
    for name, x in (("k", k), ("v", v)):
        slab = cache[name]
        up = quantize_kv(x, slab.fmt)
        slab.codes.view(torch.int32)[pidx, off] = up.codes[:, 0].view(
            torch.int32)
        slab.scales[pidx, off] = up.scales[:, 0]


def old_cache_write(cache, k, v, idx):
    """The composition B3's KV write replaced in the dense (copy-in) write:
    for K and V a packed quantize, then a per-slot ``index_put_`` (a [B]
    start) or a slice copy (an int start)."""
    import torch

    from repro_torch.models.attention import quantize_kv

    for name, x in (("k", k), ("v", v)):
        c = cache[name]
        up = quantize_kv(x, c.fmt)
        dst_w, src_w = c.codes.view(torch.int32), up.codes.view(torch.int32)
        if isinstance(idx, torch.Tensor) and idx.ndim:
            B, S = x.shape[0], x.shape[1]
            rows = torch.arange(B, device=k.device)[:, None]
            cols = idx[:, None].to(torch.int64) + torch.arange(
                S, device=k.device)
            dst_w[rows, cols] = src_w
            c.scales[rows, cols] = up.scales
        else:
            start, n = int(idx), x.shape[1]
            dst_w[:, start:start + n].copy_(src_w)
            c.scales[:, start:start + n].copy_(up.scales)


def kv_write_bitwise(dev, g, fmt, paged: bool, B=KV_SLOTS, S=1,
                     dtype="bf16", start=None, K=KV_HEADS, hd=KV_HD,
                     collide=False, max_seq=KV_MAX_SEQ) -> float:
    """B3's KV write against kv_write_plain on the same inputs, words and
    scales bitwise over the whole cache, the dump page included (rows
    sharing a position: the last in (b, s) order writes, in both);
    ``collide`` points every slot's table at the dump page at one start
    position, so all B rows share each position. Returns max |dequantized
    difference| over the written cache (0.0 when bitwise)."""
    import torch

    from repro_torch.core import qtensor as QT
    from repro_torch.kernels import f2p_quant as Q

    cache, k, v, pos, pages = kv_write_inputs(dev, g, fmt, paged, B, S,
                                              dtype, K, hd, max_seq)
    if start is not None:
        pos = start
    if collide:
        pages[:] = 0
        pos = torch.full_like(pos, 5)
    ref = _clone_cache(cache)
    Q.f2p_kv_write(k, v, cache, pos, pages)
    Q.kv_write_plain(k, v, ref, pos, pages)
    err = 0.0
    for kv in ("k", "v"):
        assert torch.equal(cache[kv].codes.view(torch.int32),
                           ref[kv].codes.view(torch.int32)), \
            f"kv_write {kv} words differ: {fmt} paged={paged} S={S} {dtype}"
        assert torch.equal(cache[kv].scales, ref[kv].scales), \
            f"kv_write {kv} scales differ: {fmt} paged={paged} S={S}"
        if not paged:
            err = max(err, float((QT.dequantize(cache[kv]) - QT.dequantize(
                ref[kv])).abs().max()))
    return err


def check_kv_write(dev, names=("f2p_sr_2_8s", "f2p_lr_1_6s")) -> dict:
    """B3's KV write (one launch for a layer's K and V into the cache) on
    the card: bitwise against kv_write_plain in both addressing modes and
    both serving formats (8-bit, and 5b's solved 6-bit), at the decode
    write (8 slots x 8 kv heads x 128, bf16; f32 too), a paged write of 16
    positions per slot (crossing pages) and a prefill call's write (4
    prompts x 256 positions from 0, dense); then, per format and mode, a
    decode layer write through the model's ``_paged_cache_write`` /
    ``_cache_write`` against the composition it replaced (old_*), timed
    the same way: ms with CUDA events around the call (the host
    included), device ms and device kernels per call from torch.profiler,
    beside the bytes bound."""
    import torch

    from repro_torch.core.formats import named_format
    from repro_torch.kernels import cost
    from repro_torch.kernels import f2p_quant as Q
    from repro_torch.models import attention as A

    g = torch.Generator(device=dev).manual_seed(6)
    err = 0.0
    for name in names:
        fmt = named_format(name)
        for paged in (True, False):
            err = max(err, kv_write_bitwise(dev, g, fmt, paged))
            err = max(err, kv_write_bitwise(dev, g, fmt, paged,
                                            dtype="f32"))
        kv_write_bitwise(dev, g, fmt, True, S=16)
        err = max(err, kv_write_bitwise(dev, g, fmt, False, B=4, S=256,
                                        start=0))
    log(f"kv write : B3 KV write == kv_write_plain, bitwise, the dump page "
        f"included ({', '.join(names)}; paged and dense; decode bf16 and "
        f"f32, 16 positions across pages, a prefill call from 0)")
    rows = {}
    for name in names:
        fmt = named_format(name)
        for mode in ("paged", "copy-in"):
            paged = mode == "paged"
            cache, k, v, pos, pages = kv_write_inputs(dev, g, fmt, paged)
            if paged:
                new = lambda: A._paged_cache_write(cache, k, v, pos, pages)
                old = lambda: old_paged_cache_write(cache, k, v, pos, pages)
                plain = lambda: Q.kv_write_plain(k, v, cache, pos, pages)
            else:
                new = lambda: A._cache_write(cache, k, v, pos)
                old = lambda: old_cache_write(cache, k, v, pos)
                plain = lambda: Q.kv_write_plain(k, v, cache, pos)
            r = dict(bound_ms=bound_ms(cost.nbytes(
                "kv_write", k, v, cache, pos, pages if paged else None)))
            for tag, fn in (("", new), ("old_", old)):
                r[tag + "ms"] = cuda_ms(fn, iters=200)
                r[tag + "device_ms"], r[tag + "kernels"] = \
                    device_ms_kernels(fn, iters=50)
            r["plain_ms"] = cuda_ms(plain, iters=10)
            rows[f"{name} {mode}"] = r
            log(f"kv write : {name:12s} {mode:7s} decode layer write "
                f"{r['ms']:.5f} ms (device {_ms(r['device_ms'])}, "
                f"{r['kernels']} kernels) vs the old composition "
                f"{r['old_ms']:.5f} ms (device {_ms(r['old_device_ms'])}, "
                f"{r['old_kernels']} kernels); bound {r['bound_ms']:.7f} "
                f"ms, plain {r['plain_ms']:.3f} ms")
    # a prefill call's write: 4 prompts x 256 positions from 0, dense
    fmt = named_format(names[0])
    cache, k, v, _, _ = kv_write_inputs(dev, g, fmt, False, B=4, S=256)
    pf = dict(bound_ms=bound_ms(cost.nbytes("kv_write", k, v, cache, 0)))
    for tag, fn in (("", lambda: A._cache_write(cache, k, v, 0)),
                    ("old_", lambda: old_cache_write(cache, k, v, 0))):
        pf[tag + "ms"] = cuda_ms(fn, iters=50)
        pf[tag + "device_ms"], pf[tag + "kernels"] = device_ms_kernels(fn)
    log(f"kv write : {names[0]} prefill write [4, 256, 8, 128] bf16 "
        f"{pf['ms']:.5f} ms (device {_ms(pf['device_ms'])}, {pf['kernels']}"
        f" kernels) vs old {pf['old_ms']:.5f} ms (device "
        f"{_ms(pf['old_device_ms'])}, {pf['old_kernels']} kernels); bound "
        f"{pf['bound_ms']:.5f} ms")
    main = rows[f"{names[0]} paged"]
    return dict(ms=main["ms"], device_ms=main["device_ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by="bytes", library_ms=None, max_abs_err=err,
                rows=rows, prefill_write=pf,
                shape=f"one layer's K and V [8, 1, 8, 128] bf16 into the "
                      f"paged pool (8-token pages, {names[0]}), one launch")


# ---------------------------------------------------------------------------
# phase 3 (continued): the unpacked codec at the train path's leaf shapes
# ---------------------------------------------------------------------------
def train_leaf_counts(cfg) -> dict:
    """Leaf shape -> number of such leaves in one llama-dense train state
    (every leaf is >= min_size 512, so every gradient is compressed)."""
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    out: dict = {}
    for shape, n in (((V, D), 1), ((D, V), 1), ((D,), 2 * L + 1),
                     ((D, q), L), ((q, D), L), ((D, kv), 2 * L),
                     ((D, F), 2 * L), ((F, D), L)):
        out[shape] = out.get(shape, 0) + n
    return out


def _bits(t):
    import torch

    view = {2: torch.int16, 4: torch.int32, 1: torch.uint8}
    return t.contiguous().view(view[t.element_size()])


def _same_bits(a, b) -> bool:
    """Bitwise equal, NaNs compared by position (a NaN's payload may differ
    between two producers)."""
    import torch

    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        if not torch.equal(na, nb):
            return False
        a, b = torch.where(na, 0, a), torch.where(nb, 0, b)
    return torch.equal(_bits(a), _bits(b))


def check_encode_exhaustive(dev) -> dict:
    """B5's table encode over every f32 bit pattern, code and decoded value
    against the arithmetic f2p_encode / f2p_decode on the card (the device
    oracle), for the gradient, checkpoint and one LR format; and the pow2
    mode's y * (1/s) against the IEEE divide for every y at s = 2^-126,
    2^-3 and 2^127. Zero mismatches, asserted."""
    import torch

    from repro_torch.core.formats import named_format
    from repro_torch.kernels import f2p_quant as Q

    t = time.perf_counter()
    out = {}
    for name in ENC_CHECK_FORMATS:
        n, first = Q.encode_check(named_format(name), device=dev)
        assert n == 0, (f"table encode != f2p_encode for {name}: {n} "
                        f"patterns, the first {first:#010x}")
        out[name] = n
    for s in POW2_CHECK_SCALES:
        n, first = Q.encode_check(named_format(ENC_CHECK_FORMATS[0]), s,
                                  device=dev)
        assert n == 0, (f"y * (1/{s!r}) != y / {s!r} for {n} patterns, the "
                        f"first {first:#010x}")
        out[f"pow2 scale {s!r}"] = n
    torch.cuda.synchronize()
    log(f"codec    : B5 table encode == f2p_encode (code and value) over all "
        f"2^32 f32 patterns for {', '.join(ENC_CHECK_FORMATS)}; pow2 "
        f"reciprocal == IEEE divide for every y at scales 2^-126, 2^-3, "
        f"2^127: 0 mismatches ({time.perf_counter() - t:.1f} s)")
    return out


def ef_check_leaves(dev, g, gdtype):
    """The round trip's bitwise-check leaves: one of each train leaf shape,
    a ragged [384, 1000] (cols % 128 != 0) and a [7, 130] (cols % 4 != 0:
    the element-wise form); an all-zero block, a NaN block and an inf block
    in the ragged leaf, a NaN in the [7, 130] leaf. Gradients randn x 1e-3
    in ``gdtype``, residuals randn x 1e-5."""
    import torch

    from repro_torch.configs import full_config

    shapes = list(train_leaf_counts(full_config(ARCH))) + [(384, 1000),
                                                           (7, 130)]
    gs = [(torch.randn(*s, generator=g, device=dev) * 1e-3).to(gdtype)
          for s in shapes]
    rs = [torch.randn(*s, generator=g, device=dev) * 1e-5 for s in shapes]
    gs[-2][0, :128] = 0
    rs[-2][0, :128] = 0
    gs[-2][1, 900] = float("nan")
    gs[-2][2, 130] = float("inf")
    gs[-1][3, 129] = float("nan")
    return shapes, gs, rs


def check_ef_roundtrip(dev, g, fmt) -> int:
    """B5's round-trip mode against ef_roundtrip_plain, bitwise in the
    gradients and the residuals (NaNs by position), bf16 and f32 gradients,
    error feedback on and off, one launch over all leaves of
    :func:`ef_check_leaves`. Returns the cases checked."""
    import torch

    from repro_torch.kernels import f2p_quant as Q

    cases = 0
    for gdtype in (torch.bfloat16, torch.float32):
        for ef in (True, False):
            shapes, gs, rs = ef_check_leaves(dev, g, gdtype)
            pg, pr = [x.clone() for x in gs], [x.clone() for x in rs]
            Q.f2p_ef_roundtrip(gs, rs, fmt, error_feedback=ef)
            for a, b in zip(pg, pr):
                Q.ef_roundtrip_plain(a, b, fmt, 128, ef)
            for s, a, b, c, d in zip(shapes, gs, rs, pg, pr):
                assert _same_bits(a, c), \
                    f"round trip: gradient {s} {gdtype} ef={ef} != plain"
                assert _same_bits(b, d), \
                    f"round trip: residual {s} {gdtype} ef={ef} != plain"
            cases += 1
            del gs, rs, pg, pr
    torch.cuda.empty_cache()
    return cases


def step_leaves(dev, g, gdtype=None):
    """One train step's compressed leaves: the 255 gradient shapes of full
    llama3.2-3b (bf16, randn x 1e-3) and zero f32 residuals."""
    import torch

    from repro_torch.configs import full_config

    gdtype = gdtype or torch.bfloat16
    gs, rs = [], []
    for shape, count in train_leaf_counts(full_config(ARCH)).items():
        for _ in range(count):
            gs.append((torch.randn(*shape, generator=g, device=dev) * 1e-3)
                      .to(gdtype))
            rs.append(torch.zeros(shape, dtype=torch.float32, device=dev))
    return gs, rs


def old_compression(gs, rs, fmt, block: int = 128) -> None:
    """The composition the round trip replaced (compress_decompress on the
    card before it): per leaf r += g, QT.quantize (B5), dequantize (B6),
    r -= q, g = q."""
    import torch

    from repro_torch.core import qtensor as QT

    for g, r in zip(gs, rs):
        gin = r.add_(g)
        q = QT.quantize(gin, fmt, block=block, packed=False).dequantize(
            torch.float32)
        r.sub_(q)
        g.copy_(q)


def check_unpacked_codec(dev):
    """The unpacked codec: B5's encode over every f32 pattern; B5 and B6
    against their plain versions at the train path's leaf shapes, bitwise
    (row chunks for the plain side); B5's round trip bitwise against its
    plain version; then times per train step (every leaf once): B5 at 8
    and 16 bits (f32 in) and B6, and the round trip beside the composition
    it replaced, with the host and on the device."""
    import gc

    import torch

    from repro_torch.configs import full_config
    from repro_torch.core.formats import named_format
    from repro_torch.kernels import cost
    from repro_torch.kernels import f2p_quant as Q

    exhaustive = check_encode_exhaustive(dev)
    g = torch.Generator(device=dev).manual_seed(4)
    grad_fmt, ckpt_fmt = named_format("f2p_sr_2_8s"), named_format(
        "f2p_sr_2_16s")
    checked, err = 0, 0.0
    for shape in ((3072, 8192), (8192, 3072), (3072, 1024), (128256, 3072),
                  (3072,)):
        x = torch.randn(*shape, generator=g, device=dev) * 1e-3
        x2 = x.reshape(-1, shape[-1])
        x2[0, :128] = 0
        for fmt in (grad_fmt, ckpt_fmt):
            for mode in ("f32", "pow2"):
                c, s = Q.f2p_quantize_codes(x2, fmt, block=128,
                                            scale_mode=mode)
                for i in range(0, x2.shape[0], 8192):
                    pc, ps = Q.quantize_plain(x2[i:i + 8192], fmt, 128, mode)
                    assert torch.equal(_bits(c[i:i + 8192]), _bits(pc)), \
                        f"B5 codes differ: {shape} {fmt.n_bits}-bit {mode}"
                    assert torch.equal(s[i:i + 8192], ps), \
                        f"B5 scales differ: {shape} {fmt.n_bits}-bit {mode}"
                    for odt in (torch.float32, torch.bfloat16):
                        pd = Q.dequantize_plain(c[i:i + 8192], s[i:i + 8192],
                                                fmt, 128, odt)
                        d = Q.f2p_dequantize_codes(
                            c[i:i + 8192].contiguous(),
                            s[i:i + 8192].contiguous(), fmt, block=128,
                            out_dtype=odt)
                        err = max(err, float((d.float() - pd.float()).abs()
                                             .max()))
                        assert torch.equal(_bits(d), _bits(pd)), \
                            f"B6 differs: {shape} {fmt.n_bits}-bit {odt}"
                checked += 1
        del x, x2
    xb = (torch.randn(3072, 8192, generator=g, device=dev)).to(torch.bfloat16)
    for fmt in (grad_fmt, ckpt_fmt):
        c, s = Q.f2p_quantize_codes(xb, fmt)
        pc, ps = Q.quantize_plain(xb, fmt, 128)
        assert torch.equal(_bits(c), _bits(pc)) and torch.equal(s, ps), \
            f"B5 bf16 input differs ({fmt.n_bits}-bit)"
    del xb
    rt_cases = check_ef_roundtrip(dev, g, grad_fmt)
    log(f"codec    : unpacked quantize/dequantize (B5/B6) == plain, bitwise, "
        f"{checked} shape x format x scale cases at the train leaf shapes "
        "(8/16-bit, f32+pow2 scales, f32+bf16 out) and bf16 input; B5's "
        f"round trip == plain in gradients and residuals, {rt_cases} cases "
        "(bf16/f32 g x error feedback on/off) over one leaf of each train "
        "shape, a ragged and a cols % 4 != 0 leaf, zero/NaN/inf blocks")

    # time per step: every leaf once
    cfg = full_config(ARCH)
    per_shape = {}
    tot = dict(q=0.0, qd=0.0, q16=0.0, q16d=0.0, d=0.0, dd=0.0, qp=0.0,
               dp=0.0, qb=0, q16b=0, db=0, n=0)
    for shape, count in train_leaf_counts(cfg).items():
        x = torch.randn(*shape, generator=g, device=dev).reshape(
            -1, shape[-1])
        c, s = Q.f2p_quantize_codes(x, grad_fmt)
        n = x.numel()
        r = dict(count=count,
                 quantize_ms=host_ms(lambda: Q.f2p_quantize_codes(
                     x, grad_fmt)),
                 quantize16_ms=host_ms(lambda: Q.f2p_quantize_codes(
                     x, ckpt_fmt)),
                 dequantize_ms=host_ms(lambda: Q.f2p_dequantize_codes(
                     c, s, grad_fmt)),
                 quantize_plain_ms=cuda_ms(lambda: Q.quantize_plain(
                     x, grad_fmt, 128), iters=2, warm=1),
                 dequantize_plain_ms=cuda_ms(lambda: Q.dequantize_plain(
                     c, s, grad_fmt, 128), iters=2, warm=1),
                 quantize_device_ms=device_ms(lambda: Q.f2p_quantize_codes(
                     x, grad_fmt), iters=10),
                 quantize16_device_ms=device_ms(lambda: Q.f2p_quantize_codes(
                     x, ckpt_fmt), iters=10),
                 dequantize_device_ms=device_ms(
                     lambda: Q.f2p_dequantize_codes(c, s, grad_fmt),
                     iters=10))
        # the profiler leaves its events behind as Python objects: collect
        # them here, so that no collector pass lands in the next host timing
        gc.collect()
        per_shape["x".join(map(str, shape))] = r
        tot["q"] += count * r["quantize_ms"]
        tot["qd"] += count * (r["quantize_device_ms"] or float("nan"))
        tot["q16"] += count * r["quantize16_ms"]
        tot["q16d"] += count * (r["quantize16_device_ms"] or float("nan"))
        tot["d"] += count * r["dequantize_ms"]
        tot["dd"] += count * (r["dequantize_device_ms"] or float("nan"))
        tot["qp"] += count * r["quantize_plain_ms"]
        tot["dp"] += count * r["dequantize_plain_ms"]
        tot["qb"] += count * cost.nbytes("quantize", x, grad_fmt)
        tot["q16b"] += count * cost.nbytes("quantize", x, ckpt_fmt)
        tot["db"] += count * cost.nbytes("dequantize", c, s, grad_fmt)
        tot["n"] += count * n
        del x, c, s
    nleaves = sum(train_leaf_counts(cfg).values())
    shape_txt = (f"one train step: {nleaves} leaves, {tot['n']} elements, "
                 "8-bit codes, f32 in/out (per-shape times in "
                 "chip_smoke.json)")
    log(f"codec    : B5 8-bit {tot['q']:.3f} ms with the host, "
        f"{tot['qd']:.3f} on the device; 16-bit {tot['q16']:.3f} / "
        f"{tot['q16d']:.3f}; B6 {tot['d']:.3f} / {tot['dd']:.3f} ms per "
        f"train step (bytes "
        f"bounds {bound_ms(tot['qb']):.3f} / {bound_ms(tot['q16b']):.3f} / "
        f"{bound_ms(tot['db']):.3f} ms; plain {tot['qp']:.1f} / "
        f"{tot['dp']:.1f} ms)")

    # the round trip per step: 255 leaves, bf16 g, f32 r, error feedback
    gs, rs = step_leaves(dev, g)
    n_el = sum(x.numel() for x in gs)
    rt = dict(ms=cuda_ms(lambda: Q.f2p_ef_roundtrip(gs, rs, grad_fmt),
                         iters=10))
    rt["device_ms"], rt["device_kernels"] = device_ms_kernels(
        lambda: Q.f2p_ef_roundtrip(gs, rs, grad_fmt), iters=5)
    gc.collect()
    rt["composition_ms"] = cuda_ms(lambda: old_compression(gs, rs, grad_fmt),
                                   iters=3, warm=1)
    rt["composition_device_ms"], rt["composition_device_kernels"] = \
        device_ms_kernels(lambda: old_compression(gs, rs, grad_fmt), iters=2)
    rt["plain_ms"] = cuda_ms(lambda: [
        Q.ef_roundtrip_plain(a, b, grad_fmt) for a, b in zip(gs, rs)],
        iters=1, warm=0)
    rt.update(bound_ms=bound_ms(cost.nbytes("ef_roundtrip", gs, rs,
                                             grad_fmt)), bound_by="bytes",
              library_ms=None, max_abs_err=0.0,
              shape=f"one train step: {len(gs)} leaves, {n_el} elements, "
                    "bf16 g + f32 r, error feedback, one launch")
    del gs, rs
    torch.cuda.empty_cache()
    log(f"codec    : round trip {rt['ms']:.3f} ms per train step with the "
        f"host, {rt['device_ms']} on the device ({rt['device_kernels']} "
        f"device kernels), bound {rt['bound_ms']:.3f}; the composition it "
        f"replaced {rt['composition_ms']:.3f} / "
        f"{rt['composition_device_ms']} ms "
        f"({rt['composition_device_kernels']} device kernels); plain "
        f"{rt['plain_ms']:.1f} ms")
    out = {
        "quantize": dict(ms=tot["q"], device_ms=tot["qd"],
                         ms_16bit=tot["q16"], device_ms_16bit=tot["q16d"],
                         bound_ms_16bit=bound_ms(tot["q16b"]),
                         plain_ms=tot["qp"], bound_ms=bound_ms(tot["qb"]),
                         bound_by="bytes", library_ms=None, max_abs_err=err,
                         shape=shape_txt, per_shape=per_shape,
                         exhaustive=exhaustive),
        "ef_roundtrip": rt,
        "dequantize": dict(ms=tot["d"], device_ms=tot["dd"],
                           plain_ms=tot["dp"],
                           bound_ms=bound_ms(tot["db"]), bound_by="bytes",
                           library_ms=None, max_abs_err=err, shape=shape_txt,
                           per_shape=per_shape)}
    return out


# phase 3's digest of B1/B2 at the default tile: (kv heads, G, head_dim,
# rows, cache positions) at llama3.2-3b's and jamba's shapes, up to 32768
# positions (256 splits of 128, the most the kernel took before caches of
# any length), each row's kv_len drawn below S with S, S - 1, 129 and 1
# among them
DIGEST_CASES = ((8, 3, 128, 4, 1024), (8, 3, 128, 4, 8192),
                (8, 3, 128, 4, 32768), (8, 8, 128, 4, 32768),
                (2, 3, 64, 4, 4096))


def attention_digest(dev, fmt_name="f2p_sr_2_8s") -> str:
    """sha256 of the bytes of B1's and B2's outputs at the default tile
    over :data:`DIGEST_CASES` (decode, a causal 4-query call, bf16 q), the
    inputs seeded on the card. It uses only what the kernels' wrappers took
    before the tile tables, so the same function on a parent tree shows
    whether a kernel change left these results bitwise as they were."""
    import hashlib

    import torch

    from repro_torch.core import qtensor as QT
    from repro_torch.core.formats import named_format
    from repro_torch.kernels import f2p_attention as A

    fmt = named_format(fmt_name)
    h = hashlib.sha256()
    for K, G, hd, B, S in DIGEST_CASES:
        g = torch.Generator(device=dev).manual_seed(S + 17 * G)
        T = 8
        maxp = S // T
        P = B * maxp + 1
        slab_k, slab_v = (QT.quantize(torch.randn(P, T, K, hd, generator=g,
                                                  device=dev),
                                      fmt, block=hd, packed=True)
                          for _ in range(2))
        pages = torch.randperm(P, generator=g, device=dev)[:B * maxp]
        pages = pages.reshape(B, maxp).to(torch.int32)
        kv_len = torch.randint(1, S + 1, (B,), generator=g, device=dev)
        kv_len[:4] = torch.tensor([S, S - 1, 129, 1], device=dev)[:B]
        dk = A.gather_pages_to_dense(slab_k, pages)
        dv = A.gather_pages_to_dense(slab_v, pages)
        q = torch.randn(B, 1, K * G, hd, generator=g, device=dev)
        qm = torch.randn(B, 4, K * G, hd, generator=g, device=dev)
        cm = dict(kv_len=kv_len, causal=True, q_offset=kv_len - 4)
        for o in (A.attention_paged(q, slab_k, slab_v, pages, kv_len=kv_len),
                  A.attention_packed(q, dk, dv, kv_len=kv_len),
                  A.attention_paged(qm, slab_k, slab_v, pages, **cm),
                  A.attention_packed(qm, dk, dv, **cm),
                  A.attention_packed(q.to(torch.bfloat16), dk, dv,
                                     kv_len=kv_len)):
            h.update(_bits(o).cpu().numpy().tobytes())
        del slab_k, slab_v, dk, dv
    torch.cuda.empty_cache()
    return h.hexdigest()


def attention_parity(dev, fmt_name="f2p_sr_2_8s") -> dict:
    """B1 and B2 at the serving decode shape (8 rows x 8 kv heads, G = 3,
    head_dim 128, kv_len 512..1024 over 8-token pages, generator seed 2):
    paged == dense over the gathered pages, bitwise, for decode, for a
    page table cut to the live span and for a causal multi-query call, the
    last also within rtol = atol = 1e-5 of the plain paged version. Runs
    the plain versions on the CPU (tests/test_torch_paged_parity.py).
    Returns the decode call's inputs and its output."""
    import torch

    from repro_torch.core import qtensor as QT
    from repro_torch.core.formats import named_format
    from repro_torch.kernels import f2p_attention as A

    g = torch.Generator(device=dev).manual_seed(2)
    fmt = named_format(fmt_name)
    B, K, G, hd, T, S = 8, 8, 3, 128, 8, 1024
    maxp = S // T
    P = (B + 1) * maxp + 1
    kv_len = torch.randint(512, S + 1, (B,), generator=g, device=dev)
    q = torch.randn(B, 1, K * G, hd, generator=g, device=dev)
    slab_k = QT.quantize(torch.randn(P, T, K, hd, generator=g, device=dev),
                         fmt, block=hd, packed=True)
    slab_v = QT.quantize(torch.randn(P, T, K, hd, generator=g, device=dev),
                         fmt, block=hd, packed=True)
    perm = torch.randperm(P, generator=g, device=dev)
    pages = perm[:B * maxp].reshape(B, maxp).to(torch.int32)
    dense_k = A.gather_pages_to_dense(slab_k, pages)
    dense_v = A.gather_pages_to_dense(slab_v, pages)
    paged = A.attention_paged(q, slab_k, slab_v, pages, kv_len=kv_len)
    dense = A.attention_packed(q, dense_k, dense_v, kv_len=kv_len)
    assert torch.equal(paged, dense), \
        f"paged != dense-over-gathered-pages on {dev}"
    span = int(-(-kv_len.max() // T))
    assert torch.equal(A.attention_paged(
        q, slab_k, slab_v, pages[:, :span].contiguous(), kv_len=kv_len),
        dense), "paged on the live span != dense on the full cache"
    # causal multi-query through both addressing modes
    qm = torch.randn(B, 4, K * G, hd, generator=g, device=dev)
    cm = dict(kv_len=kv_len, causal=True, q_offset=kv_len - 4)
    pm = A.attention_paged(qm, slab_k, slab_v, pages, **cm)
    assert torch.equal(pm, A.attention_packed(qm, dense_k, dense_v, **cm))
    torch.testing.assert_close(pm, A.attention_paged_plain(
        qm, slab_k, slab_v, pages, **cm), rtol=1e-5, atol=1e-5)
    return dict(q=q, slab_k=slab_k, slab_v=slab_v, pages=pages,
                dense_k=dense_k, dense_v=dense_v, kv_len=kv_len,
                paged=paged, dense=dense, shape=(B, K, G, hd, T, S))


def check_attention(dev, fmt_name="f2p_sr_2_8s"):
    """B1 and B2 at the serving decode shape, held to each other (bitwise,
    :func:`attention_parity`) and to their plain versions (rtol = atol =
    1e-5); then timed: ``ms`` with CUDA events around the wrapper in a
    loop (the host included), ``device_ms`` (the kernel alone,
    torch.profiler, the slabs L2-resident as in that loop), ``cold_ms``
    (the kernel alone with the L2 flushed by a 64 MB write before each
    launch: in serving the 28 layers' pools far exceed the 50 MB L2), SDPA
    on K/V dequantized up front as the yardstick, the bound, the plan's
    split and CTA counts and the device kernels per call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels import f2p_attention as A

    par = attention_parity(dev, fmt_name)
    q, slab_k, slab_v, pages = (par[k] for k in ("q", "slab_k", "slab_v",
                                                  "pages"))
    dense_k, dense_v, kv_len = par["dense_k"], par["dense_v"], par["kv_len"]
    paged, dense = par["paged"], par["dense"]
    B, K, G, hd, T, S = par["shape"]
    out = {}

    # bytes this call needs: live K/V words + scales of every (row, head)
    # at this format's row width, q in, out, the lens and (paged) the live
    # page ids
    live = int(kv_len.sum())
    nb = {"attention_paged": cost.nbytes(
              "attention_paged", q, slab_k, slab_v, pages, kv_len=kv_len),
          "attention_packed": cost.nbytes(
              "attention_packed", q, dense_k, dense_v, kv_len=kv_len)}
    plan = A.attention_plan(B, K, G, hd, S)
    ctas = int((-(-kv_len // A.ATTN_SPLIT)).sum()) * K * plan.groups
    # yardstick: SDPA over K/V dequantized up front (f32, GQA expanded)
    kd = dense_k.dequantize().repeat_interleave(G, dim=2).transpose(1, 2)
    vd = dense_v.dequantize().repeat_interleave(G, dim=2).transpose(1, 2)
    mask = (torch.arange(S, device=dev)[None, :] < kv_len[:, None])
    mask = mask[:, None, None, :]
    qs = q.transpose(1, 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, kd, vd, attn_mask=mask))
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for name, fn, plain, got in (
            ("attention_paged",
             lambda: A.attention_paged(q, slab_k, slab_v, pages,
                                       kv_len=kv_len),
             lambda: A.attention_paged_plain(q, slab_k, slab_v, pages,
                                             kv_len=kv_len), paged),
            ("attention_packed",
             lambda: A.attention_packed(q, dense_k, dense_v, kv_len=kv_len),
             lambda: A.attention_packed_plain(q, dense_k, dense_v,
                                              kv_len=kv_len), dense)):
        ref = plain()
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        dms, per_call = device_calls(fn, "attention_decode_kernel")
        cold, _ = device_calls(fn, "attention_decode_kernel",
                               flush=scratch.zero_)
        out[name] = dict(
            ms=cuda_ms(fn, iters=100), device_ms=dms, cold_ms=cold,
            plain_ms=cuda_ms(plain, iters=10),
            bound_ms=bound_ms(nb[name]), library_ms=lib_ms,
            max_abs_err=float((got - ref).abs().max()),
            split=A.ATTN_SPLIT, splits=plan.nsplit, grid=list(plan.grid),
            live_ctas=ctas, device_kernels_per_call=per_call,
            shape=f"B={B} K={K} R={G} hd={hd} span {S} kv_len 512..{S} "
                  f"(live {live}) page {T}, split {A.ATTN_SPLIT}: grid "
                  f"{plan.grid}, {ctas} live CTAs")
        r = out[name]
        log(f"attention: {name:16s} {r['ms']:.5f} ms (device "
            f"{_ms(dms)}, cold L2 {_ms(cold)}; bound {r['bound_ms']:.5f}, "
            f"SDPA {lib_ms:.5f}, plain {r['plain_ms']:.3f}); {per_call} "
            f"device kernels per call; max |err| {r['max_abs_err']:.2e}")
    del scratch
    log(f"attention: {fmt_name}: paged == dense-over-gathered bitwise (and "
        "on the live span); both within 1e-5 of the plain version (decode "
        "and causal multi-query)")
    digest = attention_digest(dev, fmt_name)
    for r in out.values():
        r["digest"] = digest
    log(f"attention: digest of B1/B2 at the default tile, {fmt_name}, over "
        f"{len(DIGEST_CASES)} cases up to 32768 positions: {digest}")
    return out


def first_batch_budget(trace, width: int, batch: int, sketch=SKETCH):
    """The (depth, width) budget the host path of a sketch configured by
    ``sketch`` (its width replaced) builds from the trace's first batch, as
    the ingest engine hands it over (per-key totals)."""
    import numpy as np

    from repro_torch.sketch import F2PSketch, SketchConfig

    keys, cnt = np.unique(trace[:batch], return_counts=True)
    sk = F2PSketch(SketchConfig(**{**sketch, "width": width}), device="cpu")
    return sk._host_budget(keys, cnt.astype(np.float32))


def live_sweeps(state, budget, luts, u) -> int:
    """Sweeps the kernel executes on these inputs: a cell runs sweep t only
    while its budget is unspent (it stops early)."""
    from repro_torch.kernels import f2p_counter as FC

    kmax = int(luts[0].shape[0]) - 1
    n, st, rem = 0, state, budget
    for t in range(u.shape[-2]):
        n += int((rem > 0).sum())
        st, rem = FC._sweep(st, rem, u.select(-2, t), *luts, kmax)
    return n


def counter_bitwise(dev, budget, formats) -> tuple[float, float]:
    """B9 against its plain version, state and leftover bitwise, from a
    zero and a random state at sweep0 0 and 32, and B10 against its plain
    version on the random state, for each (flavor, n_bits) of ``formats``
    (2 hyper-exponent bits), over ``budget``'s cells. Returns the largest
    |difference| of each (0.0 when bitwise)."""
    import numpy as np
    import torch

    from repro_torch.core.f2p import F2PFormat, Flavor
    from repro_torch.kernels import f2p_counter as FC

    shape = tuple(budget.shape)
    n = budget.numel()
    gen = np.random.default_rng(3)
    sweeps = FC.PALLAS_SWEEPS
    adv_err = est_err = 0.0
    for flavor, n_bits in formats:
        grid = F2PFormat(n_bits=n_bits, h_bits=2,
                         flavor=Flavor(flavor)).payload_grid
        luts = [torch.from_numpy(t).to(dev) for t in FC.advance_tables(grid)]
        glut = torch.tensor(grid, dtype=torch.float32, device=dev)
        rand = torch.from_numpy(gen.integers(0, len(grid) - 1, shape).astype(
            np.int32)).to(dev)
        for sname, st in (("zero", torch.zeros_like(rand)), ("random", rand)):
            for sweep0 in (0, 32):
                seed = int(gen.integers(0, 1 << 32))
                got = FC.counter_advance(st, budget, *luts, seed,
                                         sweep0=sweep0)
                u = FC.hash_uniforms(seed, sweep0, sweeps, shape, device=dev)
                want = FC.counter_advance_plain(st, budget, *luts, u)
                bad_s = int((got[0] != want[0]).sum())
                bad_l = int((got[1] != want[1]).sum())
                adv_err = max(adv_err, float((got[0] - want[0]).abs().max()),
                              float((got[1] - want[1]).abs().max()))
                assert bad_s == 0 and bad_l == 0, (
                    f"counter_advance != plain: F2P_{flavor}^2[{n_bits}] "
                    f"{sname} state, sweep0 {sweep0}: {bad_s} states and "
                    f"{bad_l} leftovers of {n} cells differ")
                # a row shard (the sharded sketch's): its lane base is its
                # first cell's global index, and it draws those cells' stream
                h = shape[0] // 2
                part = FC.counter_advance(st[h:], budget[h:], *luts, seed,
                                          sweep0=sweep0,
                                          lane_base=h * shape[1])
                assert torch.equal(part[0], want[0][h:]) and torch.equal(
                    part[1], want[1][h:]), (
                    f"counter_advance(lane_base) != the whole state's rows: "
                    f"F2P_{flavor}^2[{n_bits}] {sname}, sweep0 {sweep0}")
        est = FC.counter_estimate(rand, glut)
        ref = FC.counter_estimate_plain(rand, glut)
        est_err = max(est_err, float((est - ref).abs().max()))
        assert torch.equal(est, ref), \
            f"counter_estimate != plain: F2P_{flavor}^2[{n_bits}]"
    return adv_err, est_err


def check_counter(dev, trace, width=SKETCH["width"], batch=BATCH):
    """B9 and B10 against their plain versions on the card, at the main
    path's shapes: [4, width] state and the budget of the trace's first
    batch."""
    import torch

    from repro_torch.core.f2p import F2PFormat, Flavor
    from repro_torch.kernels import cost
    from repro_torch.kernels import f2p_counter as FC

    budget = torch.from_numpy(first_batch_budget(trace, width, batch)).to(dev)
    shape = tuple(budget.shape)
    sweeps = FC.PALLAS_SWEEPS
    out = {}
    adv_err, est_err = counter_bitwise(
        dev, budget, (("li", 8), ("li", 12), ("li", 16), ("sr", 16)))
    log("counter  : counter_advance == plain (state and leftover) and "
        "counter_estimate == plain, bitwise (8/12/16-bit LI^2, 16-bit SR^2; "
        "zero and random state; sweep0 0 and 32; the lower half of the rows "
        "with its lane base == those rows of the whole)")

    # time the main path's format on its first batch (zero state)
    grid = F2PFormat(n_bits=SKETCH["n_bits"], h_bits=SKETCH["h_bits"],
                     flavor=Flavor(SKETCH["flavor"])).payload_grid
    luts = [torch.from_numpy(t).to(dev) for t in FC.advance_tables(grid)]
    glut = torch.tensor(grid, dtype=torch.float32, device=dev)
    st = torch.zeros(shape, dtype=torch.int32, device=dev)
    u = FC.hash_uniforms(7, 0, sweeps, shape, device=dev)
    live = live_sweeps(st, budget, luts, u)
    del u
    adv_bytes = bound_ms(cost.nbytes("counter_advance", st, budget, *luts,
                                      7))
    adv_bound = max(adv_bytes,
                    live * ADVANCE_OPS_PER_SWEEP / F32_OPS_PER_S * 1e3)
    state_mid, _ = FC.counter_advance(st, budget, *luts, 7)
    out["counter_advance"] = dict(
        ms=cuda_ms(lambda: FC.counter_advance(st, budget, *luts, 7),
                   iters=100),
        plain_ms=cuda_ms(lambda: FC.counter_advance_plain(
            st, budget, *luts, FC.hash_uniforms(7, 0, sweeps, shape,
                                                device=dev)), iters=5),
        bound_ms=adv_bound,
        bound_by=("bytes" if adv_bound == adv_bytes else "operations"),
        library_ms=None, max_abs_err=adv_err, live_sweeps=live,
        shape=f"state/budget [{shape[0]}, {shape[1]}], 16-bit LI^2, first "
              f"batch's budget, {sweeps} sweeps ({live} live cell-sweeps)")
    out["counter_estimate"] = dict(
        ms=cuda_ms(lambda: FC.counter_estimate(state_mid, glut), iters=100),
        plain_ms=cuda_ms(lambda: FC.counter_estimate_plain(state_mid, glut),
                         iters=30),
        bound_ms=bound_ms(cost.nbytes("counter_estimate", state_mid, glut)),
        bound_by="bytes",
        library_ms=cuda_ms(lambda: glut[state_mid], iters=30),
        max_abs_err=est_err,
        shape=f"state [{shape[0]}, {shape[1]}] -> f32, 16-bit LI^2 grid")
    log(f"counter  : advance {out['counter_advance']['ms']:.5f} ms, "
        f"estimate {out['counter_estimate']['ms']:.5f} ms at "
        f"[{shape[0]}, {shape[1]}]")
    return out


# ---------------------------------------------------------------------------
# phase 3 (continued): the dequant matmul (B7/B8), which no model path calls
# ---------------------------------------------------------------------------
def decode_step_counts(cfg) -> dict:
    """(K, N) -> the number of such projections in one decode step of the
    full llama-dense model (q, k, v, o, gate, up, down per layer, then the
    LM head)."""
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    out: dict = {}
    for shape, n in (((D, q), L), ((q, D), L), ((D, kv), 2 * L),
                     ((D, F), 2 * L), ((F, D), L), ((D, V), 1)):
        out[shape] = out.get(shape, 0) + n
    return out


def _col_chunks(N: int, chunk: int = 16384):
    """Column ranges of at most ``chunk`` (a multiple of 32, so a packed
    row's chunk starts on a word boundary for any n_bits)."""
    return [(j, min(N, j + chunk)) for j in range(0, N, chunk)]


def _word_range(j0: int, j1: int, nb: int):
    from repro_torch.kernels.bits import packed_words

    return j0 * nb // 32, packed_words(j1, nb)


def plain_matmul(x, w, scales, fmt, packed: bool):
    """The plain version (ref_dequant_matmul, after unpack_bits for packed
    words) over column chunks of W: columns are independent, and the plain
    dequantize of a whole [3072, 128256] weight would hold ~16 GB of
    temporaries."""
    import torch

    from repro_torch.kernels import f2p_matmul as MM
    from repro_torch.kernels.bits import unpack_bits

    out = []
    for j0, j1 in _col_chunks(scales.shape[1]):
        if packed:
            w0, w1 = _word_range(j0, j1, fmt.n_bits)
            codes = unpack_bits(w[:, w0:w1].contiguous(), fmt.n_bits,
                                j1 - j0)
        else:
            codes = w[:, j0:j1].contiguous()
        out.append(MM.ref_dequant_matmul(x, codes,
                                         scales[:, j0:j1].contiguous(), fmt))
    return torch.cat(out, dim=1)


def check_quantize_weight(w, fmt, codes, scales, packed: bool):
    """quantize_weight on the card (B5 on W^T) against the plain quantizer
    on the same card, bitwise, by column chunks."""
    import torch

    from repro_torch.kernels import f2p_matmul as MM

    for j0, j1 in _col_chunks(w.shape[1]):
        pc, ps = MM.quantize_weight_plain(w[:, j0:j1].contiguous(), fmt,
                                          packed=packed)
        got = (codes[:, slice(*_word_range(j0, j1, fmt.n_bits))] if packed
               else codes[:, j0:j1])
        assert torch.equal(_bits(got), _bits(pc)), \
            f"quantize_weight {'words' if packed else 'codes'} differ: " \
            f"{tuple(w.shape)} {fmt.n_bits}-bit, columns {j0}:{j1}"
        assert torch.equal(scales[:, j0:j1], ps), \
            f"quantize_weight scales differ: {tuple(w.shape)}"


def matmul_bound(key: str, x, q, scales, fmt, kernel: str) -> dict:
    """A matmul row's bound: the larger of its bytes / 3.35 TB/s and its
    operations (2 M N K) over the rate of the kernel's arithmetic: f32 SIMT
    (decode and simt: 67 TFLOP/s) or bf16 tensor cores (mma: passes x 2 M N
    K / 989 TFLOP/s, 3 passes for f32 x, 1 for bf16 x); bytes and
    operations from kernels/cost.py."""
    import torch

    from repro_torch.kernels import cost

    nbytes = cost.nbytes(key, x, q, scales, fmt=fmt)
    ops = cost.flops(key, x, q, scales, fmt=fmt)
    x_dtype = x.dtype
    passes = (1 if x_dtype == torch.bfloat16 else 3) if kernel == "mma" \
        else None
    ops_ms = (passes * ops / BF16_OPS_PER_S if passes else
              ops / F32_OPS_PER_S) * 1e3
    return dict(bytes=nbytes, ops=ops, passes=passes,
                bytes_ms=bound_ms(nbytes), ops_ms=ops_ms,
                f32_simt_ms=ops / F32_OPS_PER_S * 1e3)


def check_matmul(dev):
    """B8 (uint8 f2p_sr_2_8s codes) and B7 (6- and 8-bit packed words) at
    llama3.2-3b's projection shapes, weights randn x 0.02 from
    torch.Generator seed 3 quantized on the card by quantize_weight (held
    bitwise to the plain quantizer). Each kernel's launches are those of one
    pass of dequant_matmul over the shapes at a decode batch (M = 8, bf16
    x), the library path that stands in for the missing model caller; then
    every call is held to the plain version (rtol 1e-4, atol 1e-4 x
    max|y_plain|) and timed beside its bound (:func:`matmul_bound`) and
    torch.matmul on the weight dequantized up front (f32, TF32 off): ``ms``
    with CUDA events around the Python wrapper in a loop (host included,
    as the kernels line has always reported it) and ``device_ms`` from
    torch.profiler over the same loop (the kernels alone). M = 8 takes the
    decode route; M = 2048 (f32 and bf16 x, x from seed 5, every shape),
    16 and 128 (f32 x, at (3072, 8192)) the tile route, on the tensor cores
    for these formats; f2p_sr_2_16s (uint16 codes, f32 x, M = 2048 at
    (3072, 8192)) the SIMT tile kernel. Each row names the kernel that
    served it. The kernels line reports one decode step of the full model
    at M = 8 (the per-shape times x decode_step_counts); the same sum at M
    = 2048 is one prefill chunk."""
    import torch

    from repro_torch.configs import full_config
    from repro_torch.core.formats import named_format
    from repro_torch.kernels import cuda as C
    from repro_torch.kernels import f2p_matmul as MM

    g = torch.Generator(device=dev).manual_seed(3)
    g5 = torch.Generator(device=dev).manual_seed(5)
    counts = decode_step_counts(full_config(ARCH))
    kinds = (("dequant_matmul", named_format("f2p_sr_2_8s"), False),
             ("dequant_matmul_packed", named_format("f2p_sr_2_6s"), True),
             ("dequant_matmul_packed_8bit", named_format("f2p_sr_2_8s"),
              True))
    simt_kind = ("dequant_matmul_16bit", named_format("f2p_sr_2_16s"), False)
    launches = {"dequant_matmul": 0, "dequant_matmul_packed": 0}
    rows = []
    for K, N in MATMUL_SHAPES:
        w = torch.randn(K, N, generator=g, device=dev) * 0.02
        wide = (K, N) == (3072, 8192)
        cases = [(8, torch.bfloat16)] + ([(2048, torch.float32)]
                                         if wide else [])
        xs = {(M, dt): torch.randn(M, K, generator=g, device=dev).to(dt)
              for M, dt in cases}
        more = [(2048, torch.bfloat16)] + ([] if wide else [
            (2048, torch.float32)]) + ([(16, torch.float32),
                                        (128, torch.float32)] if wide else [])
        for M, dt in more:
            xs[(M, dt)] = torch.randn(M, K, generator=g5, device=dev).to(dt)
        cases += more
        n_rows = len(rows)
        for kind, fmt, packed in kinds + ((simt_kind,) if wide else ()):
            q, scales = MM.quantize_weight(w, fmt, packed=packed)
            check_quantize_weight(w, fmt, q, scales, packed)
            for M, dt in (cases if kind != simt_kind[0]
                          else [(2048, torch.float32)]):
                x = xs[(M, dt)]
                key = "dequant_matmul_packed" if packed else "dequant_matmul"
                before, served = C.LAUNCHES[key], dict(MM.SERVED)
                y = MM.dequant_matmul(x, q, scales, fmt=fmt, packed=packed)
                assert C.LAUNCHES[key] - before == 1, (kind, M)
                if M == 8:
                    launches[key] += 1
                kernel = [k for k in MM.SERVED if MM.SERVED[k] != served[k]]
                assert len(kernel) == 1, kernel
                ref = plain_matmul(x, q, scales, fmt, packed)
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    y, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
                err = float((y - ref).abs().max())
                del y, ref
                big = N > 16384

                def call():
                    return MM.dequant_matmul(x, q, scales, fmt=fmt,
                                             packed=packed)

                rows.append(dict(
                    kind=kind, K=K, N=N, M=M, x=str(dt).split(".")[-1],
                    route=MM.matmul_route(M, 128), kernel=kernel[0],
                    ms=cuda_ms(call, iters=5 if M > 8 else 20),
                    device_ms=device_ms(call, iters=10 if M > 8 else 20),
                    plain_ms=cuda_ms(lambda: plain_matmul(
                        x, q, scales, fmt, packed), iters=2 if big else 5,
                        warm=1),
                    max_abs_err=err,
                    **matmul_bound(key, x, q, scales, fmt, kernel[0])))
            del q, scales
            torch.cuda.empty_cache()
        # the yardstick: one torch.matmul on W dequantized up front (f32,
        # the 8-bit unpacked weight), the same for every kind of a shape
        q, scales = MM.quantize_weight(w, kinds[0][1])
        wd = torch.cat([MM.dequantize_weight(
            q[:, j0:j1].contiguous(), scales[:, j0:j1].contiguous(),
            kinds[0][1]) for j0, j1 in _col_chunks(N)], dim=1)
        lib = {}
        for M in sorted({M for M, _ in cases}):
            xf = xs[next(c for c in cases if c[0] == M)].float()

            def mm():
                return torch.matmul(xf, wd)

            lib[M] = (cuda_ms(mm, iters=5 if M > 8 else 20),
                      device_ms(mm, iters=10 if M > 8 else 20))
            del xf
        for r in rows[n_rows:]:
            r["library_ms"], r["library_device_ms"] = lib[r["M"]]
            bound = max(r["bytes_ms"], r["ops_ms"])
            how = (f"{r['passes']} bf16 pass{'es' if r['passes'] > 1 else ''}"
                   if r["passes"] else "f32")
            log(f"matmul   : {r['kind']:27s} M={r['M']:4d} {r['x']:8s} "
                f"K={K} N={N} {r['kernel']:6s}: {r['ms']:.5f} ms, device "
                f"{_ms(r['device_ms'])} (bound {bound:.5f} by "
                f"{'bytes' if r['bytes_ms'] >= r['ops_ms'] else how}; f32 "
                f"SIMT {r['f32_simt_ms']:.5f}), plain {r['plain_ms']:.3f}, "
                f"torch.matmul {r['library_ms']:.5f} / device "
                f"{_ms(r['library_device_ms'])}, max |err| "
                f"{r['max_abs_err']:.2e}")
        del w, q, scales, wd, xs
        torch.cuda.empty_cache()
    log("matmul   : B8 and B7 (6/8-bit) == plain within rtol 1e-4 at every "
        "projection shape and M; quantize_weight == plain quantizer, "
        "bitwise")

    def total(sel, keys):
        return {k: (None if any(r[k] is None for r in sel) else
                    sum(counts[(r["K"], r["N"])] * r[k] for r in sel))
                for k in keys}

    out = {}
    for name, kind in (("dequant_matmul", "dequant_matmul"),
                       ("dequant_matmul_packed", "dequant_matmul_packed")):
        step = [r for r in rows if r["kind"] == kind and r["M"] == 8]
        keys = ("ms", "plain_ms", "library_ms", "bytes", "ops", "device_ms",
                "library_device_ms")
        tot = total(step, keys)
        b_ms = bound_ms(tot["bytes"])
        o_ms = tot["ops"] / F32_OPS_PER_S * 1e3
        out[name] = dict(
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=max(b_ms, o_ms),
            bound_by="bytes" if b_ms >= o_ms else "operations",
            library_ms=tot["library_ms"],
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r["kind"] == kind),
            launches=launches[name], device_ms=tot["device_ms"],
            library_device_ms=tot["library_device_ms"],
            shape=f"one decode step of {ARCH} at M = 8 (bf16 x): "
                  f"{sum(counts.values())} projections over "
                  f"{len(MATMUL_SHAPES)} shapes, "
                  f"{'6-bit packed' if 'packed' in name else '8-bit'} "
                  "weights (per-shape rows in chip_smoke.json)",
            rows=rows)
        log(f"matmul   : {name}: {tot['ms']:.3f} ms per decode step (bound "
            f"{max(b_ms, o_ms):.3f} ms by "
            f"{out[name]['bound_by']}, torch.matmul {tot['library_ms']:.3f}"
            f" ms, plain {tot['plain_ms']:.1f} ms; device only "
            f"{_ms(tot['device_ms'])} vs torch.matmul "
            f"{_ms(tot['library_device_ms'])} ms); {launches[name]} "
            "launches in the drive pass")
        for dt in ("float32", "bfloat16"):
            chunk = [r for r in rows if r["kind"] == kind and r["M"] == 2048
                     and r["x"] == dt]
            tp = total(chunk, keys + ("bytes_ms", "ops_ms"))
            bound = sum(counts[(r["K"], r["N"])] * max(r["bytes_ms"],
                                                       r["ops_ms"])
                        for r in chunk)
            out[name][f"prefill_{dt}"] = dict(
                ms=tp["ms"], device_ms=tp["device_ms"], bound_ms=bound,
                plain_ms=tp["plain_ms"], library_ms=tp["library_ms"],
                library_device_ms=tp["library_device_ms"],
                kernels=sorted({r["kernel"] for r in chunk}))
            log(f"matmul   : {name}: {tp['ms']:.3f} ms per prefill chunk "
                f"(M = 2048, {dt} x; device {_ms(tp['device_ms'])}, bound "
                f"{bound:.3f}, torch.matmul {tp['library_ms']:.3f} / device "
                f"{_ms(tp['library_device_ms'])}, plain "
                f"{tp['plain_ms']:.1f}) on "
                f"{'/'.join(out[name][f'prefill_{dt}']['kernels'])}")
    return out


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.5f}"


# ---------------------------------------------------------------------------
# phase 4: small model, card vs CPU
# ---------------------------------------------------------------------------
def check_small(dev, arch="llama3_2_3b", tol=1e-3, steps=6,
                tokens=False) -> dict:
    """Smoke ``arch`` in f32 on the card (kernels) against the same weights
    on the CPU (plain versions): prefill and ``steps`` decode steps'
    logits within ``tol``, fed the CPU's greedy tokens; with ``tokens``
    the card's greedy tokens must equal the CPU's at every step. An
    encoder-decoder gets seeded frames (prefill) and their encoding
    (``cross_kv``), a vision config seeded patches in front of the prompt
    (decode positions count them)."""
    import dataclasses

    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.models import (decode_step, encode, init_caches,
                                    init_params, prefill)
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(smoke_config(arch), fused_attention=True)
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = Model(cfg, dev)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 13),
                         generator=torch.Generator().manual_seed(3))
    extra, first = {}, 13
    if cfg.is_encdec or cfg.frontend == "vision":
        name = "frames" if cfg.is_encdec else "patches"
        rows = cfg.encoder_seq if cfg.is_encdec else cfg.vision_tokens
        extra[name] = torch.randn(2, rows, cfg.d_model,
                                  generator=torch.Generator().manual_seed(4))
        first += 0 if cfg.is_encdec else rows
    cross = {d: (encode(m, extra["frames"].to(d)) if cfg.is_encdec else None)
             for d, m in (("cpu", cpu), (dev, gpu))}
    # two caches (a recurrent state advances with every call, so the two
    # runs must not share one, as they would in a CPU rehearsal)
    cc, cg = (init_caches(cfg, 2, 64, quantized_kv=True, device=d)
              for d in ("cpu", dev))
    lc = prefill(cpu, toks, cc, **extra)
    lg = prefill(gpu, toks.to(dev), cg,
                 **{k: v.to(dev) for k, v in extra.items()})
    worst = float((lg.cpu() - lc).abs().max())
    same = True
    for i in range(steps):
        tok = torch.argmax(lc, -1)[:, None]
        same &= bool(torch.equal(torch.argmax(lg, -1).cpu()[:, None], tok))
        lc = decode_step(cpu, tok, first + i, cc, cross_kv=cross["cpu"])
        lg = decode_step(gpu, tok.to(dev), first + i, cg,
                         cross_kv=cross[dev])
        worst = max(worst, float((lg.cpu() - lc).abs().max()))
    same &= bool(torch.equal(torch.argmax(lg, -1).cpu(), torch.argmax(lc, -1)))
    assert worst < tol, f"{arch}: card vs CPU logits differ by {worst}"
    assert same or not tokens, f"{arch}: card and CPU greedy tokens differ"
    log(f"small    : smoke {cfg.name} (f32) card vs CPU logits max |diff| "
        f"{worst:.3e} over prefill + {steps} decode steps (< {tol}); greedy "
        f"tokens {'equal' if same else 'differ'}")
    return dict(max_abs_diff=worst, tokens_equal=same)


# ---------------------------------------------------------------------------
# phase 5: full-width serving
# ---------------------------------------------------------------------------
def serve(dev, launches):
    import numpy as np
    import torch

    from repro_torch.configs import full_config
    from repro_torch.kernels import cuda as C
    from repro_torch.models import init_params
    from repro_torch.serve import (BatchedEngine, BatchedServeConfig, Engine,
                                   Request, ServeConfig)

    cfg = full_config("llama3_2_3b")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"serve    : {cfg.name} {cfg.n_layers}L d={cfg.d_model} "
        f"H={cfg.n_heads}/{cfg.n_kv_heads} ff={cfg.d_ff} V={cfg.vocab_size} "
        f"{cfg.dtype}, {cfg.param_count() / 1e9:.2f}B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=u + 1,
                    tokens=rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(16, 257))
                                        ).astype(np.int32),
                    max_new=32, arrival=4 * u) for u in range(16)]
    bs = dict(slots=8, max_seq=1024)

    def run(tag, **kw):
        eng = BatchedEngine(cfg, BatchedServeConfig(**bs, **kw), model)
        C.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = dict(C.LAUNCHES)
        ntok = sum(len(v) for v in out.values())
        assert sorted(out) == [r.uid for r in reqs], f"{tag}: lost requests"
        for r in reqs:
            o = out[r.uid]
            assert len(o) == r.max_new, f"{tag}: request {r.uid} short"
            assert ((o >= 0) & (o < cfg.vocab_size)).all()
        st = eng.stats
        # B3's KV write: one launch per layer per decode step and per
        # prefill call, in both modes
        writes = cfg.n_layers * (st["steps"] + st.get("prefill_calls", 0))
        assert counts["kv_write"] == writes, \
            f"{tag}: {counts['kv_write']} kv_write launches, not {writes}"
        log(f"serve    : {tag}: {len(out)} requests, {ntok} tokens in "
            f"{dt:.2f} s = {ntok / dt:.1f} tok/s (wall, prefill included); "
            f"{st['rounds']} rounds, {st.get('prefill_calls', 0)} prefill "
            f"calls, occupancy {st['slot_occupancy']:.2f}, pool peak "
            f"{st['pool']['peak_used']}/{st['pool']['n_pages']} pages; "
            f"launches {counts}")
        st["latency"] = engine_latency(tag, eng)
        return out, counts, ntok / dt, st

    run("warm-up (paged)")
    paged, cnt_p, tps_p, st_p = run("paged")
    st_p["tok_s"] = tps_p
    copy_in, cnt_c, tps_c, _ = run("copy-in", paged_decode=False)
    for r in reqs:
        assert np.array_equal(paged[r.uid], copy_in[r.uid]), \
            f"request {r.uid}: paged != copy-in"
    log("serve    : paged == copy-in, token for token, all 16 requests")
    launches["attention_paged"] = cnt_p["attention_paged"]
    # B3's two modes: the KV write (every cache write of the engine) and
    # contiguous rows
    launches["quantize_packed"] = cnt_p["kv_write"] + cnt_p["quantize_packed"]
    launches["quantize_packed_modes"] = {
        m: cnt_p[m] for m in ("kv_write", "quantize_packed")}
    launches["attention_packed"] = cnt_c["attention_packed"]

    # the unfused engine (ServeConfig's default): each decode step reads
    # every layer's whole K and V cache back through B4's K+V mode
    eng = Engine(cfg, ServeConfig(batch=1, max_seq=1024, quantized_kv=True),
                 model)
    C.reset_launches()
    short = eng.generate(reqs[0].tokens[None], 4)
    torch.cuda.synchronize()
    cnt_u = dict(C.LAUNCHES)
    reads = cfg.n_layers * (4 - 1)
    assert cnt_u["kv_read"] == reads and cnt_u["dequantize_packed"] == 0, \
        f"unfused engine: {cnt_u['kv_read']} kv_read launches (not {reads})" \
        f", {cnt_u['dequantize_packed']} single-mode"
    assert np.array_equal(short[0], paged[reqs[0].uid][:4]), \
        "unfused engine's first 4 tokens differ from the paged run's"
    launches["dequantize_packed"] = cnt_u["kv_read"] + \
        cnt_u["dequantize_packed"]
    launches["dequantize_packed_modes"] = {
        m: cnt_u[m] for m in ("kv_read", "dequantize_packed")}
    unfused = unfused_tbt(eng, reqs[0].tokens[None])
    log(f"serve    : Engine(fused_attention=False) 4 tokens, launches "
        f"{cnt_u}; tokens == paged; decode {unfused['ms_per_token']:.3f} ms "
        f"per token ({unfused['tokens']} tokens after the prefill)")

    seq = Engine(cfg, ServeConfig(batch=1, max_seq=1024, quantized_kv=True,
                                  fused_attention=True), model)
    agree = total = 0
    for r in reqs:
        o = seq.generate(r.tokens[None], r.max_new)[0]
        agree += int((o == paged[r.uid]).sum())
        total += r.max_new
    log(f"serve    : sequential Engine agreement {agree}/{total} tokens "
        "(printed, not asserted)")
    assert cnt_p["kv_write"] > 0 and cnt_c["kv_write"] > 0
    for name, n in launches.items():
        if not name.endswith("_modes"):
            assert n > 0, f"kernel {name} never launched on its path"
    policy = serve_policy(dev, cfg, model, reqs, bs, run, paged, st_p)
    return dict(paged_tok_s=tps_p, copy_in_tok_s=tps_c,
                seq_agreement=f"{agree}/{total}", rounds=st_p["rounds"],
                unfused=unfused,
                latency=st_p["latency"], pool=st_p["pool"], policy=policy,
                profile=profile_decode(cfg, model, bs))


def unfused_tbt(eng, prompt, n=33, repeats=3) -> dict:
    """Decode time per token of a sequential Engine: (a run of n tokens - a
    run of 1, the prefill and the cache set-up) / (n - 1), host clock around
    runs that end in a sync, the median of ``repeats``."""
    import statistics

    import torch

    def run(k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.generate(prompt, k)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    runs = [(run(n) - run(1)) / (n - 1) * 1e3 for _ in range(repeats)]
    return dict(ms_per_token=statistics.median(runs), runs=runs,
                tokens=n - 1)


def engine_latency(tag: str, eng) -> dict:
    """TTFT and TBT p50 / p99 from the engine's obs registry (the exact
    shadows and the F2P cells' estimate) and its admission events."""
    m, st = eng.metrics, eng.stats
    out = {}
    for name in ("ttft_ms", "tbt_ms", "queue_wait_ms"):
        h = m[name]
        out[name] = {f"p{int(q * 100)}{suffix}": h.quantile(q, exact=exact)
                     for q in (0.5, 0.99)
                     for suffix, exact in (("", True), ("_f2p", False))}
        out[name]["count"] = h.count
    out["events"] = {k: st.get(k, 0) for k in (
        "prefills", "preemptions", "host_evictions", "readmits")}
    log(f"serve    : {tag}: TTFT p50 {out['ttft_ms']['p50']:.1f} / p99 "
        f"{out['ttft_ms']['p99']:.1f} ms (F2P estimate "
        f"{out['ttft_ms']['p50_f2p']:.1f} / {out['ttft_ms']['p99_f2p']:.1f}),"
        f" TBT p50 {out['tbt_ms']['p50']:.2f} / p99 "
        f"{out['tbt_ms']['p99']:.2f} ms (F2P "
        f"{out['tbt_ms']['p50_f2p']:.2f} / {out['tbt_ms']['p99_f2p']:.2f}); "
        f"admits {out['events']['prefills']}, preemptions "
        f"{out['events']['preemptions']}, evictions "
        f"{out['events']['host_evictions']}, readmits "
        f"{out['events']['readmits']}")
    return out


def calibrate_kv(dev, cfg, model, reqs) -> dict:
    """One calibration state for kv/b0: the K and V of all layers from a
    prefill of each of ``reqs`` (batch 1, exact length) into unquantized
    caches, block-normalized per head_dim row (NORM_SPEC)."""
    import torch

    from repro_torch.autotune import NORM_SPEC, empty_state, update
    from repro_torch.models import init_caches, prefill

    state = empty_state(NORM_SPEC, dev)
    for r in reqs:
        caches = init_caches(cfg, 1, len(r.tokens), device=dev)
        prefill(model, torch.as_tensor(r.tokens[None], device=dev).long(),
                caches)
        for kv in ("k", "v"):
            state = update(state, caches["b0"][kv], NORM_SPEC,
                           block=cfg.head_dim)
    return state


def serve_policy(dev, cfg, model, reqs, bs, run, base_out, base_st) -> dict:
    """Phase 5b: calibrate the KV of the first 4 requests, solve kv/b0 over
    the 6- and 8-bit F2P candidates at 6.25 bits/elem (a 6-bit code plus
    an f32 scale per 128: the lowest-error 6-bit partition), hold B1 and
    B3 to their plain versions at the solved format, then serve the
    phase-5 workload paged and copy-in under that policy: tokens bitwise
    equal between the modes, every request finished, B1 and B3 launched."""
    import numpy as np
    import torch

    from repro_torch.autotune import (NORM_SPEC, LeafSpec, candidate_formats,
                                      scale_rms, solve, to_dist)
    from repro_torch.autotune.policy import _leaf_bits, _leaf_error
    from repro_torch.core.formats import named_format

    t0 = time.perf_counter()
    state = calibrate_kv(dev, cfg, model, reqs[:4])
    leaf = LeafSpec(path="kv/b0", size=int(state["n"]),
                    last_dim=cfg.head_dim, dist=to_dist(state, NORM_SPEC),
                    scale_rms=scale_rms(state))
    cands = candidate_formats(n_bits=KV_CANDIDATE_BITS)
    pol = solve([leaf], cands, KV_BUDGET_BITS, block=cfg.head_dim)
    fmt = pol.rules[0].fmt
    table = sorted(((c, _leaf_bits(leaf, c, cfg.head_dim) / leaf.size,
                     _leaf_error(leaf, c) / leaf.size) for c in cands),
                   key=lambda r: (r[1], r[2]))
    log(f"policy   : calibrated {leaf.size} K/V elements of {len(reqs[:4])} "
        f"prompts ({time.perf_counter() - t0:.1f} s), scale_rms "
        f"{leaf.scale_rms:.4g}; solve at {KV_BUDGET_BITS} bits/elem over "
        f"{len(cands)} candidates -> kv/b0 = {fmt}")
    for c, bits, err in table:
        log(f"policy   :   {c:14s} {bits:.4f} bits/elem, modeled MSE "
            f"{err:.4e}" + ("  <- chosen" if c == fmt else ""))
    assert named_format(fmt).n_bits == 6, f"solver picked {fmt}"
    six = [r for r in table if named_format(r[0]).n_bits == 6]
    assert fmt == min(six, key=lambda r: r[2])[0]

    # B1 and B3 at the solved format, against their plain versions
    g = torch.Generator(device=dev).manual_seed(5)
    codec_bitwise(dev, g, named_format(fmt))
    for paged in (True, False):
        kv_write_bitwise(dev, g, named_format(fmt), paged)
    attn = check_attention(dev, fmt)
    log(f"policy   : {fmt}: quantize/dequantize kernels and the KV write == "
        f"plain, bitwise; attention within 1e-5")

    kw = dict(kv_policy=pol)
    paged, cnt_p, tps_p, st_p = run(f"paged, kv/b0 {fmt}", **kw)
    copy_in, cnt_c, tps_c, _ = run(f"copy-in, kv/b0 {fmt}",
                                   paged_decode=False, **kw)
    for r in reqs:
        assert np.array_equal(paged[r.uid], copy_in[r.uid]), \
            f"request {r.uid}: paged != copy-in under {fmt}"
    assert cnt_p["attention_paged"] > 0 and cnt_p["kv_write"] > 0
    assert cnt_c["attention_packed"] > 0 and cnt_c["kv_write"] > 0
    agree = sum(int((paged[r.uid] == base_out[r.uid]).sum()) for r in reqs)
    total = sum(r.max_new for r in reqs)
    pb, pb8 = st_p["pool"]["pool_bytes_packed"], \
        base_st["pool"]["pool_bytes_packed"]
    live, live8 = st_p["pool"]["page_bytes_packed"], \
        base_st["pool"]["page_bytes_packed"]
    log(f"policy   : paged == copy-in under {fmt}, token for token; "
        f"{tps_p:.1f} / {tps_c:.1f} tok/s (8-bit paged "
        f"{base_st['tok_s']:.1f}); pool {pb} B vs {pb8} B at 8 bits "
        f"({pb / pb8:.4f}), {live} vs {live8} B per page; tokens equal to "
        f"the 8-bit run {agree}/{total} (printed)")
    return dict(fmt=fmt, candidates=table, scale_rms=leaf.scale_rms,
                elements=leaf.size, paged_tok_s=tps_p, copy_in_tok_s=tps_c,
                pool_bytes=pb, pool_bytes_8bit=pb8, page_bytes=live,
                page_bytes_8bit=live8, agree_8bit=f"{agree}/{total}",
                launches_paged=cnt_p, launches_copy_in=cnt_c,
                latency=st_p["latency"], attention=attn)


def profile_decode(cfg, model, bs) -> dict:
    """torch.profiler over a short paged run (8 requests of 64 tokens, 2
    prefill calls, or 8 for a family prefilled at exact length, + 16
    decode steps): the device's busy share of the wall time, each kernel's
    device time per call, and the top kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import BatchedEngine, BatchedServeConfig, Request

    rng = np.random.default_rng(1)
    reqs = [Request(uid=u + 1, tokens=rng.integers(0, cfg.vocab_size, 64),
                    max_new=17) for u in range(8)]
    eng = BatchedEngine(cfg, BatchedServeConfig(**bs), model)
    eng.run(reqs)                       # same shapes, outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    res = device_profile(prof, wall_us, ("attention_decode_kernel",
                                         "quantize_packed"))
    st = eng.stats      # 2 prefill calls of 4, or 8 exact-length ones
    log_profile(f"{st['prefill_calls']} prefill calls + {st['steps']} "
                f"decode steps", res)
    return res


# ---------------------------------------------------------------------------
# phase 7: the measurement path
# ---------------------------------------------------------------------------
def sketch_phase(dev, trace, launches, *, width=SKETCH["width"],
                 batch=BATCH, track_top=256, window=4) -> dict:
    """2 passes of the trace through SketchIngestEngine -> F2PSketch on
    ``dev``, each flushed; the launch counters are zeroed before the first
    pass and read after the final flush and estimates()."""
    import numpy as np
    import torch

    from repro_torch.kernels import cuda as C
    from repro_torch.serve import SketchIngestEngine
    from repro_torch.sketch import (F2PSketch, SketchConfig, hash_rows_np,
                                    make_hash_params)

    cfg = SketchConfig(**{**SKETCH, "width": width})
    t0 = time.perf_counter()
    uniq, cnt = np.unique(trace, return_counts=True)
    cnt = cnt * 2                                # two identical passes
    order = np.argsort(cnt)[::-1]
    log(f"sketch   : trace {trace.size} packets, {uniq.size} flows, top "
        f"flow {cnt[order[0]] // 2} per pass (truth in "
        f"{time.perf_counter() - t0:.1f} s)")
    sk = F2PSketch(cfg, device=dev)
    eng = SketchIngestEngine(sk, batch=batch, track_top=track_top)
    rng = np.random.default_rng(1)
    C.reset_launches()
    sync(dev)
    rates, flush_launches, flush_s = [], [], []
    for phase in ("cold", "steady"):
        t = time.perf_counter()
        pos = 0
        while pos < trace.size:      # odd-sized chunks, as a packet feed
            n = int(rng.integers(10_000, 90_000))
            eng.ingest(trace[pos:pos + n])
            pos += n
        before, tf = C.LAUNCHES["counter_advance"], time.perf_counter()
        eng.flush()
        sync(dev)
        flush_s.append(time.perf_counter() - tf)
        flush_launches.append(C.LAUNCHES["counter_advance"] - before)
        dt = time.perf_counter() - t
        rates.append(trace.size / dt)
        log(f"sketch   : {phase} pass {trace.size} packets in {dt:.2f} s = "
            f"{rates[-1] / 1e6:.2f} M arrivals/s (flush included: "
            f"{flush_s[-1]:.2f} s, {flush_launches[-1]} advance launches)")
    est = sk.estimates()
    sync(dev)
    counts = dict(C.LAUNCHES)
    launches["counter_advance"] = counts["counter_advance"]
    launches["counter_estimate"] = counts["counter_estimate"]
    assert eng.packets == 2 * trace.size, eng.packets
    assert sk.pending_budget == 0.0, sk.pending_budget
    top = uniq[order[:10]]
    rep = eng.heavy_hitters(20)
    missing = sorted(set(top.tolist()) - set(rep.keys.tolist()))
    assert not missing, f"true top-10 flows missing from the report: {missing}"
    q = sk.query(top)
    rel = (q - cnt[order[:10]]) / cnt[order[:10]]
    worst = float(np.abs(rel).max())
    mean_abs = float(np.abs(rel).mean())
    log(f"sketch   : top-10 relative errors {np.round(rel, 5).tolist()} "
        f"(largest {worst:.5f}, mean |error| {mean_abs:.5f}; "
        f"{int((np.abs(rel) <= 0.02).sum())} of 10 within 2%)")
    # A fixed 2% per flow is about 2 sigma of the min over 4 rows of 16-bit
    # counters at these counts, so it fails on about half of all seeds with
    # nothing wrong. Each flow's query is held instead to the law of its
    # own cells: 4 counters with the true cell totals (collisions included)
    # advanced from zero, min over rows, sampled `trials` times.
    sim_mean, sim_sd = simulated_query(dev, cfg, sk.grid, uniq, cnt, top)
    with np.errstate(divide="ignore", invalid="ignore"):
        # a flow inside the grid's exact dense head has sd 0: equal or fail
        z = np.where(sim_sd > 0, (q - sim_mean) / sim_sd,
                     np.where(q == sim_mean, 0.0, np.inf))
    log(f"sketch   : top-10 queries against their simulated law: z "
        f"{np.round(z, 3).tolist()}, relative sd "
        f"{np.round(sim_sd / cnt[order[:10]], 5).tolist()}")
    assert np.abs(z).max() <= 5.0, f"a top-10 query is {np.abs(z).max():.2f} "\
        "sd from its simulated law"
    assert mean_abs <= 0.02, f"top-10 mean |error| {mean_abs:.4%}"
    assert est.shape == (cfg.depth, cfg.width) and np.isfinite(est).all()
    probe = np.concatenate([uniq[order[:1000]],
                            rng.choice(uniq, min(10_000, uniq.size),
                                       replace=False)])
    a, b = make_hash_params(cfg.depth, seed=cfg.seed)
    idx = hash_rows_np(probe, a, b, cfg.width)
    assert np.array_equal(
        est[np.arange(cfg.depth)[:, None], idx].min(axis=0),
        sk.query(probe)), "query != min over rows of estimates()"
    st = eng.stats()
    log(f"sketch   : {st['batches']} batches, fill {st['sketch_fill']:.4f}, "
        f"{st['sketch_bytes']} B of 16-bit registers; launches {counts}")
    for name in ("counter_advance", "counter_estimate"):
        # (a CPU rehearsal runs the plain versions: nothing launches)
        assert launches[name] > 0 or torch.device(dev).type == "cpu", \
            f"kernel {name} never launched"
    res = dict(packets=eng.packets, batches=st["batches"],
               cold_arrivals_per_s=rates[0], steady_arrivals_per_s=rates[1],
               flush_s=flush_s, flush_launches=flush_launches,
               fill=st["sketch_fill"], top10_rel_err=rel.tolist(),
               top10_worst=worst, top10_mean_abs=mean_abs,
               top10_z=z.tolist(),
               top10_sim_rel_sd=(sim_sd / cnt[order[:10]]).tolist(),
               launches=counts)
    if torch.device(dev).type == "cuda":
        res["profile"] = profile_sketch(eng, trace, window * batch)
    res["device_key_path"] = device_key_path(dev, trace, cfg, batch)
    res["on_arrival"] = on_arrival(dev)
    res["obs"] = obs_sync(dev)
    return res


def simulated_query(dev, cfg, grid, uniq, cnt, keys, trials=1024):
    """Mean and sd of the count-min query of ``keys`` under the counter's
    own law: each row's cell receives the true total of every flow hashed
    to it, a batch-independent budget (aggregating arrivals into budgets is
    exact in distribution), advanced from zero with counter_advance_exact;
    the query is the min over rows. ``trials`` independent draws."""
    import numpy as np
    import torch

    from repro_torch.kernels import f2p_counter as FC
    from repro_torch.sketch import hash_rows_np, make_hash_params

    a, b = make_hash_params(cfg.depth, seed=cfg.seed)
    rows = np.arange(cfg.depth)[:, None]
    totals = np.zeros((cfg.depth, cfg.width))
    np.add.at(totals, (rows, hash_rows_np(uniq, a, b, cfg.width)),
              np.broadcast_to(cnt, (cfg.depth, cnt.size)))
    cell = totals[rows, hash_rows_np(keys, a, b, cfg.width)]   # (depth, k)
    assert cell.max() < FC.MAX_EXACT_BUDGET
    budget = torch.tensor(np.broadcast_to(cell, (trials,) + cell.shape),
                          dtype=torch.float32, device=dev)
    luts = [torch.from_numpy(t).to(dev) for t in FC.advance_tables(grid)]
    glut = torch.tensor(grid, dtype=torch.float32, device=dev)
    st, _ = FC.counter_advance_exact(
        torch.zeros(budget.shape, dtype=torch.int32, device=dev),
        budget.contiguous(), *luts, seed=12345)
    q = FC.counter_estimate(st, glut).double().min(dim=1).values  # (trials, k)
    return q.mean(0).cpu().numpy(), q.std(0).cpu().numpy()


def profile_sketch(eng, trace, n) -> dict:
    """torch.profiler over a steady window: ``n`` more packets through the
    engine, then one estimates()."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    keys = trace[:n]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.ingest(keys)
        eng.sketch.estimates()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    res = device_profile(prof, wall_us, ("counter_advance_kernel",
                                         "counter_estimate_kernel"))
    res["arrivals_per_s"] = n / (wall_us / 1e6)
    log_profile(f"steady ingest window of {n} packets + estimates()", res)
    res["host_ms_per_batch"] = batch_breakdown(eng, trace[:eng.batch])
    return res


def batch_breakdown(eng, keys) -> dict:
    """Host clock (synchronised) over the steps of one batch as the engine
    runs them: pre-combine, host aggregation, budget upload, advance,
    candidate query. Leaves the sketch one batch further on."""
    import numpy as np
    import torch

    sk = eng.sketch
    out = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t) * 1e3
        return r

    uniq, cnt = step("engine_unique", lambda: np.unique(keys,
                                                        return_counts=True))
    budget = step("sketch_host_budget", lambda: sk._host_budget(
        uniq, cnt.astype(np.float32)))
    dev_budget = step("budget_upload", lambda: torch.from_numpy(budget).to(
        sk.device))
    step("advance", lambda: sk._advance(dev_budget + sk._carry))
    top = uniq[np.argsort(cnt)[::-1][:4 * eng.hh.capacity]]
    step("candidate_query", lambda: sk.query(top))
    log("profile  :   one batch on the host clock (ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in out.items()))
    return out


def device_key_path(dev, trace, cfg, batch) -> dict:
    """One batch of keys as a tensor on the card: torch hash -> scatter ->
    advance, against the host path, bitwise, on a unit grid (the advance
    is deterministic there)."""
    import numpy as np
    import torch

    from repro_torch.kernels import cuda as C
    from repro_torch.sketch import F2PSketch

    grid = np.arange(1 << 16, dtype=np.float64)
    keys = trace[:batch]
    host = F2PSketch(cfg, grid=grid, device=dev)
    host.update(keys)
    on_dev = F2PSketch(cfg, grid=grid, device=dev)
    C.reset_launches()
    t = time.perf_counter()
    on_dev.update(torch.from_numpy(keys).to(dev))
    sync(dev)
    dt = time.perf_counter() - t
    n = C.LAUNCHES["counter_advance"]
    assert n > 0 or torch.device(dev).type == "cpu"
    assert torch.equal(host.state, on_dev.state), \
        "device-key path != host path"
    assert on_dev.arrivals == host.arrivals == batch
    log(f"sketch   : device-key path ({batch} keys as a tensor) == host "
        f"path, bitwise; {dt * 1e3:.1f} ms, advance launches {n}")
    return dict(ms=dt * 1e3, launches=n)


def on_arrival(dev, cells=4096, n_arrivals=512, oracle_trials=4096) -> dict:
    """Per-arrival exact advances of ``cells`` 8-bit LI^2 counters: the
    on-arrival MSE against the closed-form simulator of core.counters. The
    oracle runs 4096 trials: at the 16 trials of benchmarks/run.py its own
    spread is about +-30% (seed 0 gives 5042 against a 4000-trial mean
    near 3808)."""
    import numpy as np
    import torch

    from repro_torch.core.counters import f2p_li_grid, on_arrival_mse
    from repro_torch.kernels import f2p_counter as FC

    grid = f2p_li_grid(8)
    luts = [torch.from_numpy(t).to(dev) for t in FC.advance_tables(grid)]
    glut = torch.tensor(grid, dtype=torch.float32, device=dev)
    state = torch.zeros(cells, dtype=torch.int32, device=dev)
    one = torch.ones(cells, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    sq = torch.zeros((), dtype=torch.float64, device=dev)
    for i in range(n_arrivals):
        state, _ = FC.counter_advance_exact(
            state, one, *luts, int(rng.integers(0, 1 << 32)))
        est = FC.counter_estimate(state, glut).double()
        sq += ((est - (i + 1)) ** 2).mean()
    mse = float(sq) / n_arrivals
    oracle = on_arrival_mse(grid, n_arrivals, trials=oracle_trials, seed=0)
    ratio = mse / oracle
    log(f"sketch   : on-arrival MSE {mse:.1f} vs oracle {oracle:.1f} "
        f"({oracle_trials} trials): ratio {ratio:.4f}")
    assert 0.8 <= ratio <= 1.25, f"on-arrival MSE ratio {ratio:.4f}"
    return dict(mse=mse, oracle=oracle, ratio=ratio)


def obs_sync(dev) -> dict:
    """An obs registry whose cells advance on the card: 10^6 increments over
    a 1000-cell CounterVector, one sync."""
    import numpy as np

    from repro_torch.kernels import cuda as C
    from repro_torch.obs import MetricsRegistry

    reg = MetricsRegistry("chip.obs", device=dev, register=False)
    vec = reg.counter_vector("cells", 1000)
    vec.add(np.random.default_rng(2).integers(0, 1000, 10 ** 6))
    C.reset_launches()
    reg.sync()
    n = C.LAUNCHES["counter_advance"]
    exact = vec.exact
    assert exact.sum() == 10 ** 6 and exact.max() < 4096
    assert np.array_equal(vec.estimates(), exact), \
        "obs estimates != exact shadows in the 16-bit dense head"
    log(f"obs      : MetricsRegistry(device={dev}) sync, advance launches "
        f"{n}; 1000 estimates == exact shadows (max {int(exact.max())})")
    return dict(launches=n)


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------
def train_configs(cfg):
    """launch/train.py's optimizer, compression and data configs."""
    from repro_torch.launch.train import train_configs as configs

    return configs(cfg, arch=ARCH, steps=TRAIN_STEPS,
                   global_batch=TRAIN_BATCH, seq=TRAIN_SEQ)[:3]


class StepStalls:
    """What a train step spent outside its own work: the caching
    allocator's retries (a failed cudaMalloc frees every cached block and
    tries again), its cudaMalloc / cudaFree calls (segments allocated and
    freed), the reserved bytes after the step, and the time Python's
    garbage collector ran, in all and in its longest pass (with that
    pass's generation). ``take()`` returns the deltas since the last
    call."""

    KEYS = {"alloc_retries": "num_alloc_retries",
            "cuda_mallocs": "segment.all.allocated",
            "cuda_frees": "segment.all.freed"}

    def __init__(self):
        import gc

        self.gc_s, self.gc_max, self._t0 = 0.0, (0.0, -1), None
        gc.callbacks.append(self._gc)
        self._last = self._read()

    def _gc(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            dt = time.perf_counter() - self._t0
            self.gc_s += dt
            self.gc_max = max(self.gc_max, (dt, info["generation"]))
            self._t0 = None

    def _read(self) -> dict:
        import torch

        st = torch.cuda.memory_stats()
        return {k: st.get(v, 0) for k, v in self.KEYS.items()}

    def take(self) -> dict:
        import torch

        now = self._read()
        out = {k: now[k] - self._last[k] for k in now}
        out["reserved_gib"] = torch.cuda.memory_reserved() / 2**30
        out["gc_ms"] = 1e3 * self.gc_s
        out["gc_max_ms"] = 1e3 * self.gc_max[0]
        out["gc_max_gen"] = self.gc_max[1]
        self._last, self.gc_s, self.gc_max = now, 0.0, (0.0, -1)
        return out

    def close(self):
        import gc

        gc.callbacks.remove(self._gc)


class Step0RoundTrip:
    """Holds a train step's compressed gradients and residuals to the plain
    round trip: post-accumulate-grad hooks apply ``ef_roundtrip_plain`` on
    the card to each compressed leaf's g and r as autograd hands them over
    (before the step compresses them) and keep the result on the host;
    :meth:`check`, after the step, removes the hooks and asserts each
    leaf's gradient and residual equal to it, bitwise. Returns the count."""

    def __init__(self, model, res, ccfg):
        from repro_torch.kernels import f2p_quant as Q

        self.model, self.res, self.want = model, res, {}

        def hook(name):
            def fn(p):
                wg, wr = p.grad.clone(), res[name].clone()
                Q.ef_roundtrip_plain(wg, wr, ccfg.fmt, ccfg.block)
                self.want[name] = (wg.cpu(), wr.cpu())
            return fn

        self.handles = [p.register_post_accumulate_grad_hook(hook(n))
                        for n, p in model.named_parameters()
                        if res[n] is not None]

    def check(self, tag: str) -> int:
        import torch

        for h in self.handles:
            h.remove()
        assert len(self.want) == len(self.handles), \
            f"{tag}: {len(self.want)} of {len(self.handles)} leaves hooked"
        for name, p in self.model.named_parameters():
            if name in self.want:
                wg, wr = self.want[name]
                assert torch.equal(_bits(p.grad), _bits(wg.to(p.device))), \
                    f"{tag}: compressed gradient of {name} != plain round trip"
                assert torch.equal(_bits(self.res[name]),
                                   _bits(wr.to(p.device))), \
                    f"{tag}: residual of {name} != plain g + r - q"
        n = len(self.want)
        self.want.clear()
        return n


def train_phase(dev, launches) -> dict:
    """(a): 8 steps of the full-depth trainer on the card."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import full_config
    from repro_torch.data import host_batch
    from repro_torch.kernels import cuda as C
    from repro_torch.train import init_train_state, make_train_step

    cfg = full_config(ARCH)
    ocfg, ccfg, dcfg = train_configs(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, ocfg, ccfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model, res = state["params"], state["residuals"]
    n_comp = sum(r is not None for r in res.values())
    log(f"train    : {cfg.name} {cfg.n_layers}L {cfg.param_count() / 1e9:.2f}B "
        f"params {cfg.dtype}, remat {cfg.remat}, batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ}; state on the card in {init_s:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB; {n_comp} of "
        f"{len(res)} gradient leaves compressed ({ccfg.fmt.n_bits}-bit, "
        f"block {ccfg.block})")

    step0 = Step0RoundTrip(model, res, ccfg)
    step_fn = make_train_step(cfg, ocfg, ccfg)
    losses, step_s, per_step, prof_res, stalls = [], [], [], None, []
    gnorms = []
    C.reset_launches()
    torch.cuda.synchronize()
    watch = StepStalls()
    for step in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in host_batch(dcfg, step).items()}
        before = dict(C.LAUNCHES)
        ctx = profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) \
            if step == 1 else contextlib.nullcontext()
        with ctx as prof:
            t = time.perf_counter()
            state, m = step_fn(state, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
        if prof is not None:
            prof_res = device_profile(prof, dt * 1e6, ("ef_roundtrip_kernel",
                                                       "quantize_kernel"))
            # the profiler leaves millions of Python objects behind: a
            # full collection here keeps a gen-2 pass over them (seconds)
            # out of the timed steps
            del prof
            gc.collect()
        step_s.append(dt)
        losses.append(loss)
        gnorms.append(float(m["grad_norm"]))
        stalls.append(watch.take())
        nrt = C.LAUNCHES["ef_roundtrip"] - before["ef_roundtrip"]
        nq = C.LAUNCHES["quantize"] - before["quantize"]
        nd = C.LAUNCHES["dequantize"] - before["dequantize"]
        per_step.append((nrt, nq, nd))
        assert math.isfinite(loss), f"step {step}: loss {loss}"
        assert nrt == 1 and nq == nd == 0, \
            (f"step {step}: {nrt} round-trip launches (1 wanted), B5 {nq} / "
             f"B6 {nd} per-leaf launches (0 wanted), {n_comp} leaves")
        if step == 0:
            assert step0.check("step 0") == n_comp
            log(f"train    : step 0 compressed gradients and residuals == "
                f"plain round trip on g + r, bitwise, all {n_comp} leaves")
        st = stalls[-1]
        log(f"train    : step {step} loss {loss:.4f} gnorm "
            f"{float(m['grad_norm']):.3f} {dt * 1e3:.1f} ms, round trip "
            f"{nrt} (B5 {nq} B6 {nd})"
            f"; allocator retries {st['alloc_retries']} cudaMalloc "
            f"{st['cuda_mallocs']} cudaFree {st['cuda_frees']}, reserved "
            f"{st['reserved_gib']:.2f} GiB, gc {st['gc_ms']:.1f} ms (longest "
            f"{st['gc_max_ms']:.1f} ms, gen {st['gc_max_gen']})"
            + (" (profiled)" if step == 1 else ""))
    watch.close()
    counts = dict(C.LAUNCHES)
    launches["ef_roundtrip"] = counts["ef_roundtrip"]
    peak = torch.cuda.max_memory_allocated()
    steady = step_s[2:]
    ms = 1e3 * sum(steady) / len(steady)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3)
    rt = sum(v["calls"] * v["device_ms_per_call"]
             for k, v in prof_res["kernels"].items() if "ef_roundtrip" in k)
    log_profile("train step 1", prof_res)
    log(f"train    : steps 2-{TRAIN_STEPS - 1}: {ms:.1f} ms per step, "
        f"{tok_s:.0f} tokens/s; peak allocated {peak / 2**30:.2f} GiB; "
        f"device busy {100 * (prof_res['device_busy_share'] or 0):.1f}% of "
        f"step 1; the round trip {rt:.3f} ms device time per step")
    out = dict(arch=cfg.name, layers=cfg.n_layers, params=cfg.param_count(),
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, init_s=init_s,
               losses=losses, grad_norms=gnorms,
               step_ms=[1e3 * x for x in step_s],
               ms_per_step=ms, tokens_per_s=tok_s, peak_alloc_bytes=peak,
               compressed_leaves=n_comp, launches_per_step=per_step,
               stalls_per_step=stalls,
               launches=counts, roundtrip_device_ms_per_step=rt,
               profile=prof_res)
    del state, model, res, step_fn
    return out


def train_resume_phase(dev) -> dict:
    """(b): launch.train.run at full width, 2 layers: save at step 2,
    restore into a fresh state (bitwise against the plain codec's round
    trip), resume for steps 2-3."""
    import dataclasses
    import gc
    import json as _json
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import full_config
    from repro_torch.kernels import cuda as C
    from repro_torch.launch.train import run
    from repro_torch.train import checkpoint, init_train_state

    cfg = dataclasses.replace(full_config(ARCH), n_layers=2)
    ocfg, ccfg, _ = train_configs(cfg)
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(d).free
        C.reset_launches()
        state, info = run(cfg, arch=ARCH, steps=2, global_batch=TRAIN_BATCH,
                          seq=TRAIN_SEQ, ckpt_dir=d, ckpt_every=2,
                          device=dev, log=lambda *a: log("train    :", *a))
        torch.cuda.synchronize()
        save_launches = dict(C.LAUNCHES)
        step_dir = os.path.join(d, "step_2")
        disk = sum(os.path.getsize(os.path.join(step_dir, f))
                   for f in os.listdir(step_dir))
        with open(os.path.join(step_dir, "index.json")) as f:
            index = _json.load(f)["leaves"]
        fresh = init_train_state(cfg, ocfg, ccfg, seed=1, device=dev)
        C.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        checkpoint.restore(d, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        restore_launches = dict(C.LAUNCHES)
        assert int(fresh["opt"]["step"]) == 2
        saved, got = checkpoint.flatten(state), checkpoint.flatten(fresh)
        n_q, _ = check_restored(saved, got, index)
        log(f"train    : checkpoint step 2: {disk} B on disk ({free / 1e9:.0f}"
            f" GB free), {n_q} F2P16 leaves + {len(index) - n_q} raw; "
            f"snapshot {info['ckpt']['snapshot_s'][-1]:.2f} s + write "
            f"{info['ckpt']['write_s'][-1]:.2f} s, restore {restore_s:.2f} s;"
            f" restored leaves == plain codec round trip / raw, bitwise")
        del state, fresh, saved, got
        gc.collect()
        torch.cuda.empty_cache()
        state, info2 = run(cfg, arch=ARCH, steps=4, global_batch=TRAIN_BATCH,
                           seq=TRAIN_SEQ, ckpt_dir=d, ckpt_every=100,
                           device=dev, log=lambda *a: log("train    :", *a))
        resumed = [h["loss"] for h in info2["history"]]
        assert info2["start"] == 2 and len(resumed) == 2, info2["start"]
        assert all(math.isfinite(x) for x in resumed), resumed
        del state
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, losses=[h["loss"] for h in
                                             info["history"]],
                resumed_losses=resumed, ckpt_bytes=disk, disk_free=free,
                snapshot_s=info["ckpt"]["snapshot_s"][-1],
                write_s=info["ckpt"]["write_s"][-1], restore_s=restore_s,
                f2p16_leaves=n_q, raw_leaves=len(index) - n_q,
                save_launches=save_launches,
                restore_launches=restore_launches)


# ---------------------------------------------------------------------------
# phase 9: federated learning and fault injection
# ---------------------------------------------------------------------------
def fl_leaves(min_size=1024):
    """(reference path, shape) of toy_task()'s leaves the client compresses
    (every float leaf of at least ``min_size`` elements), in the
    reference's order."""
    from repro_torch.autotune.policy import leaf_path_str
    from repro_torch.fl import toy_task
    from repro_torch.fl._tree import leaves_with_path

    cfg, _, _, init = toy_task()
    return [(leaf_path_str(p), tuple(x.shape))
            for p, x in leaves_with_path(init(cfg, 0, "cpu"))
            if x.numel() >= min_size]


def check_fl_codec(dev) -> dict:
    """B3 (contiguous rows) and B5 (codes) through ``QT.quantize``, B4
    (single mode) and B6 through ``QTensor.dequantize``, at toy_task()'s
    stacked leaf shapes, against their plain versions on the card: words /
    codes, scales and values bitwise (NaNs by position); 8- and 6-bit
    formats, f32 and pow2 scales, blocks 32 / 64 / 128 capped at the
    leaf's last dim as the client caps them; row 0 all zero, a NaN in row
    1's first block."""
    import torch

    from repro_torch.autotune.policy import candidate_formats
    from repro_torch.core import qtensor as QT
    from repro_torch.core.formats import named_format
    from repro_torch.kernels import cuda as C
    from repro_torch.kernels import f2p_quant as Q

    cands = candidate_formats(n_bits=(6, 8))
    assert all(f in cands for f in FL_FORMATS), FL_FORMATS
    g = torch.Generator(device=dev).manual_seed(9)
    shapes = fl_leaves()
    cases = 0
    C.reset_launches()
    for _, shape in shapes:
        x = torch.randn(*shape, generator=g, device=dev) * 1e-3
        x2 = x.view(-1, shape[-1])
        x2[0] = 0
        x2[1, 0] = float("nan")
        for name in FL_FORMATS:
            fmt = named_format(name)
            for blk in sorted({min(b, shape[-1]) for b in FL_BLOCKS}):
                for mode in ("f32", "pow2"):
                    for packed in (False, True):
                        qt = QT.quantize(x, fmt, block=blk, packed=packed,
                                         scale_mode=mode)
                        plain = (Q.quantize_packed_plain if packed
                                 else Q.quantize_plain)
                        pc, ps = plain(x2, fmt, blk, mode)
                        tag = f"{shape} {name} block {blk} {mode}"
                        assert _same_bits(qt.codes.reshape(pc.shape), pc), \
                            f"B{3 if packed else 5} codes differ: {tag}"
                        assert _same_bits(qt.scales.reshape(ps.shape), ps), \
                            f"B{3 if packed else 5} scales differ: {tag}"
                        d = qt.dequantize(torch.float32)
                        pd = (Q.dequantize_packed_plain if packed
                              else Q.dequantize_plain)(pc, ps, fmt, blk)
                        assert _same_bits(d, pd.reshape(shape)), \
                            f"B{4 if packed else 6} values differ: {tag}"
                        cases += 1
    counts = {k: C.LAUNCHES[k] for k in ("quantize_packed",
                                         "dequantize_packed", "quantize",
                                         "dequantize")}
    assert counts["quantize_packed"] == counts["quantize"] == cases // 2
    assert counts["dequantize_packed"] == counts["dequantize"] == cases // 2
    log(f"fl       : B3/B5 (quantize) and B4/B6 (dequantize) == plain, "
        f"bitwise, {cases} cases at the {len(shapes)} FL leaf shapes "
        f"({', '.join(str(s) for _, s in shapes)}): {', '.join(FL_FORMATS)}"
        f", f32/pow2 scales, blocks {FL_BLOCKS} capped at the last dim, "
        "packed and unpacked, zero and NaN blocks")
    return dict(cases=cases, shapes=[list(s) for _, s in shapes],
                formats=list(FL_FORMATS))


def fl_compressed(ccfg) -> int:
    """How many leaves of a toy_task() update the client ships as QTensors
    under ``ccfg`` (its min_size, wire-shrink and policy decisions, run on
    a zero delta on the CPU: no kernel launch)."""
    import torch

    from repro_torch.core.qtensor import QTensor
    from repro_torch.fl import client as FC
    from repro_torch.fl import toy_task
    from repro_torch.fl._tree import leaves, tree_map

    cfg, _, _, init = toy_task()
    zero = tree_map(torch.zeros_like, init(cfg, 0, "cpu"))
    upd, _ = FC._quantize_delta(zero, FC.init_client_residuals(zero, ccfg),
                                ccfg)
    return sum(isinstance(x, QTensor) for x in leaves(upd))


def _codec_launches() -> dict:
    from repro_torch.kernels import cuda as C

    return {k: C.LAUNCHES[k] for k in ("quantize_packed", "dequantize_packed",
                                       "quantize", "dequantize")}


def fl_fedavg(dev) -> dict:
    """examples/fed_avg.py's three configs on the card (toy_task(), 4
    clients x 5 rounds x 2 local steps, lr 0.1): f32 deltas, F2P8 codes
    (B5 per client leaf, B6 for the residual and the float server) and
    packed words under an autotuned 6/8-bit policy (B3, B4). Asserts the
    example's acceptance and each kernel's launches per client leaf."""
    import dataclasses

    import torch

    from repro_torch.fl import (AutotuneConfig, ClientConfig, FedAvgConfig,
                                run_fed_avg, toy_task)
    from repro_torch.kernels import cuda as C

    a = FL_FEDAVG
    task = toy_task()
    base = ClientConfig(local_steps=a["local_steps"], lr=a["lr"])
    configs = {
        "f32": (dataclasses.replace(base, compress=False), None),
        "f2p8": (base, None),
        "f2p packed-mixed": (
            dataclasses.replace(base, packed=True),
            AutotuneConfig(every=2, n_bits=(6, 8),
                           budget_bits_per_elem=a["packed_budget"])),
    }
    # warm-up: each config through a solve and a round under its policy
    for ccfg, at in configs.values():
        run_fed_avg(FedAvgConfig(n_clients=a["n_clients"], rounds=3,
                                 client=ccfg, autotune=at), task, device=dev)
    torch.cuda.synchronize()
    runs, out = {}, {}
    for name, (ccfg, at) in configs.items():
        fcfg = FedAvgConfig(n_clients=a["n_clients"], rounds=a["rounds"],
                            client=ccfg, autotune=at)
        C.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        hist = run_fed_avg(fcfg, task, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = _codec_launches()
        # launches from the run's leaf list and cohort: one quantize per
        # compressed leaf, client and round; one dequantize per leaf for
        # the float server's contribution and one for the residual
        nq = fl_compressed(ccfg)
        if hist["policy"] is not None:
            assert fl_compressed(dataclasses.replace(
                ccfg, policy=hist["policy"])) == nq
        per = nq * fcfg.n_clients * fcfg.rounds if ccfg.compress else 0
        ndq = per * (1 + int(ccfg.error_feedback))
        want = {"quantize_packed": per if ccfg.packed else 0,
                "dequantize_packed": ndq if ccfg.packed else 0,
                "quantize": 0 if ccfg.packed else per,
                "dequantize": 0 if ccfg.packed else ndq}
        assert got == want, f"fed-avg {name}: launches {got} != {want}"
        assert all(math.isfinite(v) for v in hist["eval_loss"]), name
        runs[name] = hist
        out[name] = dict(
            eval_loss=hist["eval_loss"],
            wire_bytes_per_round=hist["wire_bytes_per_round"],
            round_seconds=hist["round_seconds"], wall_s=wall,
            compressed_leaves=nq if ccfg.compress else 0, launches=got,
            policy=(None if hist["policy"] is None
                    else hist["policy"].describe()))
        log(f"fl       : fed-avg {name}: eval loss "
            f"{[round(v, 5) for v in hist['eval_loss']]}, wire bytes/round "
            f"{hist['wire_bytes_per_round']}, round s "
            f"{[round(v, 4) for v in hist['round_seconds']]} (after a "
            f"warm-up), launches {got}")
        if hist["policy"] is not None:
            log(f"fl       : fed-avg {name}: solved policy\n"
                f"{hist['policy'].describe()}")
    wire = {k: r["wire_bytes_per_round"][-1] for k, r in runs.items()}
    loss = {k: r["eval_loss"][-1] for k, r in runs.items()}
    acc = dict(wire_ratio=wire["f32"] / wire["f2p8"],
               f2p8_loss_ratio=loss["f2p8"] / loss["f32"],
               packed_wire_drop=1 - wire["f2p packed-mixed"] / wire["f2p8"],
               packed_loss_ratio=loss["f2p packed-mixed"] / loss["f2p8"])
    log(f"fl       : fed-avg acceptance: wire f32/f2p8 "
        f"{acc['wire_ratio']:.4f}x (>= 3.5), f2p8 loss "
        f"{acc['f2p8_loss_ratio']:.5f}x f32 (<= 1.05), packed-mixed wire "
        f"{100 * acc['packed_wire_drop']:.2f}% below f2p8 (>= 20%) at "
        f"{acc['packed_loss_ratio']:.5f}x its loss (<= 1.001)")
    assert acc["wire_ratio"] >= 3.5, acc
    assert acc["f2p8_loss_ratio"] <= 1.05, acc
    assert acc["packed_wire_drop"] >= 0.20, acc
    assert acc["packed_loss_ratio"] <= 1.001, acc
    out["acceptance"] = acc
    return out


def fl_fleet(dev) -> dict:
    """README's fleet deployment on the card (FleetConfig(n_clients=1000,
    sample=64, quorum=32), 3 rounds, client_batch 16, pow2 scales, no error
    feedback): fault-free, under chaos-small, packed under the corrupt
    plan, and under reorder + duplicates (bitwise equal to fault-free).
    Asserts chaos-small's final loss within 1.05x of fault-free's, finite
    committed models and one B5 (B3 packed) launch per compressed leaf,
    client and round, and no dequantize (the exact fold is host integer
    work); then profiles one fault-free round."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.faults import FaultPlan, named_plan
    from repro_torch.fl import FleetConfig, run_fleet_rounds, toy_task
    from repro_torch.fl import rounds as R
    from repro_torch.fl._tree import leaves
    from repro_torch.kernels import cuda as C

    task = toy_task()
    base = FleetConfig(**FL_FLEET)
    packed = dataclasses.replace(
        base, client=dataclasses.replace(base.client, packed=True))
    runs = {"fault-free": (base, None),
            "chaos-small": (base, named_plan("chaos-small")),
            "corrupt (packed)": (packed, named_plan("corrupt")),
            "reorder+duplicate": (base, FaultPlan(seed=5, duplicate=0.5,
                                                  reorder=True))}
    for cfg in (base, packed):    # warm-up
        run_fleet_rounds(dataclasses.replace(cfg, rounds=1, sample=16,
                                             quorum=1), task, device=dev)
    hists, out = {}, {}
    for name, (flcfg, plan) in runs.items():
        C.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        hist = run_fleet_rounds(flcfg, task, faults=plan, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = _codec_launches()
        cohort = min(flcfg.sample, flcfg.n_clients)
        per = fl_compressed(flcfg.client) * cohort * flcfg.rounds
        pk = bool(flcfg.client.packed)
        want = {"quantize_packed": per if pk else 0, "dequantize_packed": 0,
                "quantize": 0 if pk else per, "dequantize": 0}
        assert got == want, f"fleet {name}: launches {got} != {want}"
        for leaf in leaves(hist["params"]):
            assert bool(torch.isfinite(leaf).all()), f"{name}: non-finite"
        lag = R._REGS["fl.fleet"]["arrival_lag_s"]
        rs = hist["round_seconds"]
        hists[name] = hist
        out[name] = dict(
            {k: hist[k] for k in ("eval_loss", "committed", "admitted",
                                  "late_folded", "dropped", "failed",
                                  "quarantined", "dup_skipped", "expired",
                                  "retries", "wire_bytes_per_round",
                                  "round_seconds")},
            wall_s=wall, launches=got,
            clients_per_s=[cohort / x for x in rs],
            arrival_lag_p50_s=lag.quantile(0.5),
            arrival_lag_p99_s=lag.quantile(0.99))
        log(f"fl       : fleet {name}: {wall:.2f} s, launches {got}, "
            f"arrival lag p50 {lag.quantile(0.5):.4f} s p99 "
            f"{lag.quantile(0.99):.4f} s (virtual, obs registry)")
        for r in range(flcfg.rounds):
            log(f"fl       :   round {r}: admitted {hist['admitted'][r]} "
                f"late {hist['late_folded'][r]} dropped "
                f"{hist['dropped'][r]} failed {hist['failed'][r]} "
                f"quarantined {hist['quarantined'][r]} dup "
                f"{hist['dup_skipped'][r]} committed {hist['committed'][r]}"
                f"; wire {hist['wire_bytes_per_round'][r]} B; eval loss "
                f"{hist['eval_loss'][r]:.5f}; {rs[r]:.3f} s wall = "
                f"{cohort / rs[r]:.1f} clients/s")
    clean, chaos = hists["fault-free"], hists["chaos-small"]
    ratio = chaos["eval_loss"][-1] / clean["eval_loss"][-1]
    assert ratio <= 1.05, f"chaos-small loss {ratio:.4f}x fault-free"
    assert all(clean["committed"]), clean["committed"]
    dup = hists["reorder+duplicate"]
    assert sum(dup["dup_skipped"]) > 0
    for a, b in zip(leaves(clean["params"]), leaves(dup["params"])):
        assert torch.equal(_bits(a), _bits(b)), \
            "reorder + duplicates changed the committed parameters"
    assert dup["eval_loss"] == clean["eval_loss"]
    assert sum(hists["corrupt (packed)"]["quarantined"]) > 0
    log(f"fl       : fleet chaos-small final loss {ratio:.5f}x fault-free "
        f"(<= 1.05); reorder + duplicates ({sum(dup['dup_skipped'])} "
        "duplicates skipped) committed bitwise-equal parameters")
    # one fault-free round under the profiler: the device's busy share
    one = dataclasses.replace(base, rounds=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run_fleet_rounds(one, task, device=dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    prof_res = device_profile(prof, wall_us, ("quantize", "dequantize"))
    log_profile(f"fl fleet round ({one.sample} clients)", prof_res)
    del prof
    out["profile"] = prof_res
    # the same round under the obs spans: where its wall time goes
    from repro_torch import obs

    obs.enable()
    try:
        run_fleet_rounds(one, task, device=dev)
        spans = obs.get().tracer.summary()["spans"]
    finally:
        obs.disable()
    ms = {k: spans[k]["total_us"] / 1e3 for k in ("fl.round", "fl.compute",
                                                   "fl.client")}
    split = dict(round_ms=ms["fl.round"], clients_ms=ms["fl.client"],
                 host_copy_ms=ms["fl.compute"] - ms["fl.client"],
                 fold_and_eval_ms=ms["fl.round"] - ms["fl.compute"],
                 clients=spans["fl.client"]["count"])
    log(f"fl       : fleet round split (obs spans, host clock): "
        f"{split['round_ms']:.1f} ms = {split['clients']} clients' SGD + "
        f"quantize {split['clients_ms']:.1f} ms + the chunks' host copies "
        f"{split['host_copy_ms']:.1f} ms + delivery, exact fold, commit and "
        f"eval {split['fold_and_eval_ms']:.1f} ms")
    out["round_split"] = split
    out["chaos_loss_ratio"] = ratio
    return out


def fl_wrap_engine(dev) -> dict:
    """faults.wrap_engine over the sequential Engine on smoke llama3.2-3b on
    the card: a benign plan returns the bare engine's tokens; a plan with
    dropout 1.0 loses every request."""
    import numpy as np

    from repro_torch.configs import smoke_config
    from repro_torch.faults import DroppedRequest, FaultPlan, wrap_engine
    from repro_torch.models import init_params
    from repro_torch.serve import Engine, ServeConfig

    cfg = smoke_config("llama3_2_3b")
    eng = Engine(cfg, ServeConfig(batch=2, max_seq=64, quantized_kv=True),
                 init_params(cfg, seed=0, device=dev))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = eng.generate(prompts, 8)
    got = wrap_engine(eng, FaultPlan()).generate(prompts, 8)
    assert np.array_equal(got, want), "wrap_engine(FaultPlan()) changed tokens"
    lost = wrap_engine(eng, FaultPlan(dropout=1.0))
    for _ in range(4):
        try:
            lost.generate(prompts, 8)
        except DroppedRequest:
            continue
        raise AssertionError("dropout=1.0 served a request")
    log(f"fl       : wrap_engine on smoke llama3.2-3b: FaultPlan() tokens == "
        f"bare engine's {list(want.shape)}; dropout=1.0 dropped "
        f"{lost.stats['dropped']} of 4 requests")
    return dict(tokens_equal=True, dropped=lost.stats["dropped"])


def fl_phase(dev) -> dict:
    """Phase 9: (a) the FL kernels at the leaf shapes, (b) fed-avg, (c)
    fleet rounds under faults, (d) their launches, (e) wrap_engine."""
    t = time.perf_counter()
    res = dict(codec=check_fl_codec(dev), fedavg=fl_fedavg(dev),
               fleet=fl_fleet(dev), wrap_engine=fl_wrap_engine(dev))
    # each FL kernel's launches over the FL main path: fed-avg and fleet
    launches = {k: 0 for k in _codec_launches()}
    for part in (res["fedavg"], res["fleet"]):
        for r in part.values():
            if isinstance(r, dict) and "launches" in r:
                for k, n in r["launches"].items():
                    launches[k] += n
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t
    log(f"fl       : phase 9 in {res['seconds']:.1f} s; FL launches "
        f"{launches}")
    return res


def fl_summary(fl: dict) -> dict:
    """Phase 9's JSON line: per run its losses, wire bytes, round seconds
    and launches; the fleet's accounting; the acceptance ratios."""
    fleet = {k: {f: v[f] for f in (
        "eval_loss", "committed", "admitted", "late_folded", "dropped",
        "failed", "quarantined", "dup_skipped", "wire_bytes_per_round",
        "round_seconds", "clients_per_s", "arrival_lag_p50_s",
        "arrival_lag_p99_s", "launches")}
        for k, v in fl["fleet"].items() if isinstance(v, dict)
        and "eval_loss" in v}
    prof = fl["fleet"]["profile"]
    return dict(
        codec_cases=fl["codec"]["cases"],
        fedavg={k: {f: v[f] for f in ("eval_loss", "wire_bytes_per_round",
                                      "round_seconds", "launches")}
                for k, v in fl["fedavg"].items() if k != "acceptance"},
        acceptance=fl["fedavg"]["acceptance"], fleet=fleet,
        chaos_loss_ratio=fl["fleet"]["chaos_loss_ratio"],
        fleet_round_busy_share=prof["device_busy_share"],
        fleet_round_wall_ms=prof["wall_ms"],
        fleet_round_split=fl["fleet"]["round_split"],
        launches=fl["launches"],
        seconds=fl["seconds"])


# ---------------------------------------------------------------------------
# phase 10: the MoE family and the other dense configs
# ---------------------------------------------------------------------------
def attention_at(dev, K, G, hd, fmt_name="f2p_sr_2_8s", *, B=8, S=1024,
                 kv=(512, 1024), q_dtype="float32", tag="families") -> dict:
    """B1 (paged) and B2 (dense, over the gathered pages) at (kv heads K,
    query rows per kv head G, head_dim hd): B slots x S positions over
    8-token pages, kv_len drawn in ``kv`` (inclusive), q in ``q_dtype``.
    Paged == dense bitwise. With f32 q each is within rtol = atol = 1e-5 of
    its plain version. With bf16 q (a model's decode) the kernel reads q
    into f32 and rounds o once, so its bf16 output must be its f32 output
    on the same q values rounded, bitwise; that f32 output within 1e-5 of
    the plain version's, and the bf16 outputs within one bf16 rounding of
    each other. ms with the host (CUDA events around the wrapper), device
    ms (torch.profiler) and the bytes bound."""
    import torch

    from repro_torch.core import qtensor as QT
    from repro_torch.core.formats import named_format
    from repro_torch.kernels import cost
    from repro_torch.kernels import f2p_attention as A

    g = torch.Generator(device=dev).manual_seed(10)
    fmt = named_format(fmt_name)
    T = 8
    maxp = S // T
    P = (B + 1) * maxp + 1
    kv_len = torch.randint(kv[0], kv[1] + 1, (B,), generator=g, device=dev)
    q = torch.randn(B, 1, K * G, hd, generator=g, device=dev).to(
        getattr(torch, q_dtype))
    slab_k, slab_v = (QT.quantize(torch.randn(P, T, K, hd, generator=g,
                                              device=dev),
                                  fmt, block=hd, packed=True)
                      for _ in range(2))
    pages = torch.randperm(P, generator=g, device=dev)[:B * maxp].reshape(
        B, maxp).to(torch.int32)
    dense_k = A.gather_pages_to_dense(slab_k, pages)
    dense_v = A.gather_pages_to_dense(slab_v, pages)
    calls = {
        "attention_paged": (
            lambda x: A.attention_paged(x, slab_k, slab_v, pages,
                                        kv_len=kv_len),
            lambda x: A.attention_paged_plain(x, slab_k, slab_v, pages,
                                              kv_len=kv_len)),
        "attention_packed": (
            lambda x: A.attention_packed(x, dense_k, dense_v, kv_len=kv_len),
            lambda x: A.attention_packed_plain(x, dense_k, dense_v,
                                               kv_len=kv_len))}
    paged, dense = (kern(q) for kern, _ in calls.values())
    assert torch.equal(paged, dense), \
        f"B1 != B2 over the gathered pages at K={K} G={G} hd={hd}"
    nb = {"attention_paged": cost.nbytes(
              "attention_paged", q, slab_k, slab_v, pages, kv_len=kv_len),
          "attention_packed": cost.nbytes(
              "attention_packed", q, dense_k, dense_v, kv_len=kv_len)}
    plan = A.attention_plan(B, K, G, hd, S)
    out = {}
    for (name, (kern, plain)), got in zip(calls.items(), (paged, dense)):
        ref = plain(q)
        if q.dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        else:
            wide = kern(q.float())
            assert torch.equal(got, wide.to(q.dtype)), \
                f"{name}: {q_dtype} q is not its f32 result rounded"
            torch.testing.assert_close(wide, plain(q.float()), rtol=1e-5,
                                       atol=1e-5)
            torch.testing.assert_close(got.float(), ref.float(),
                                       rtol=2 ** -7, atol=1e-5)
        fn = lambda: kern(q)
        dms, per_call = device_calls(fn, "attention_decode_kernel")
        out[name] = dict(ms=cuda_ms(fn, iters=100), device_ms=dms,
                         plain_ms=cuda_ms(lambda: plain(q), iters=5),
                         bound_ms=bound_ms(nb[name]),
                         max_abs_err=float((got.float() - ref.float())
                                           .abs().max()),
                         q_dtype=q_dtype, shape=f"B={B} S={S} kv_len "
                         f"{kv[0]}..{kv[1]}", rows=plan.rows,
                         groups=plan.groups,
                         device_kernels_per_call=per_call)
        r = out[name]
        log(f"{tag:9s}: K={K:2d} G={G} hd={hd:3d} {name:16s} "
            f"{r['ms']:.5f} ms (device {_ms(dms)}; bound "
            f"{r['bound_ms']:.5f}, plain {r['plain_ms']:.3f}); {r['shape']}, "
            f"{q_dtype} q; rows {plan.rows} x {plan.groups} groups per kv "
            f"head; max |err| {r['max_abs_err']:.2e}")
    return out


def kv_read_at(dev, K, hd, fmt_name, B, S, tag="frontend") -> dict:
    """B4's K+V mode (f2p_kv_read, the unfused decode's read) on one layer
    view of a 2-layer packed cache [B, S, K, hd] at block hd: bitwise
    against kv_read_plain with bf16 and f32 out, timed with the host and on
    the device beside its bytes bound and the plain version."""
    import torch

    from repro_torch.core.formats import named_format
    from repro_torch.kernels import cost
    from repro_torch.kernels import f2p_quant as Q

    g = torch.Generator(device=dev).manual_seed(14)
    fmt = named_format(fmt_name)
    cache = kv_read_cache(dev, g, fmt, B=B, S=S, K=K, hd=hd)
    assert cache["k"].block == hd
    for odt in (torch.bfloat16, torch.float32):
        for a, b in zip(Q.f2p_kv_read(cache, odt), Q.kv_read_plain(cache, odt)):
            assert torch.equal(_bits(a), _bits(b)), \
                f"kv_read differs: {fmt_name} K={K} hd={hd} {odt}"
    fn = lambda: Q.f2p_kv_read(cache, torch.bfloat16)
    nb = cost.nbytes("kv_read", cache, torch.bfloat16)
    dms, per_call = device_calls(fn, "dequantize_packed_kernel")
    r = dict(ms=host_ms(fn, iters=100), device_ms=dms,
             device_kernels_per_call=per_call, bound_ms=bound_ms(nb),
             plain_ms=cuda_ms(lambda: Q.kv_read_plain(cache, torch.bfloat16),
                              iters=10), max_abs_err=0.0,
             shape=f"[{B}, {S}, {K}, {hd}] {fmt_name} block {hd} -> bf16")
    log(f"{tag:9s}: K={K:2d} hd={hd:3d} kv_read {r['shape']} {r['ms']:.5f} "
        f"ms (device {_ms(dms)}; bound {r['bound_ms']:.5f}, plain "
        f"{r['plain_ms']:.3f}); bitwise with bf16 and f32 out")
    return r


def kv_write_at(dev, K, hd, fmt_name="f2p_sr_2_8s") -> dict:
    """B3's KV write at (K, hd), bf16 K and V of 8 slots: bitwise against
    kv_write_plain over the whole cache in both addressing modes, and with
    every slot on the dump page at one position (the last slot writes);
    the paged decode layer write timed with the host and on the device,
    beside its bytes bound."""
    import torch

    from repro_torch.core.formats import named_format
    from repro_torch.kernels import cost
    from repro_torch.kernels import f2p_quant as Q
    from repro_torch.models import attention as A

    g = torch.Generator(device=dev).manual_seed(11)
    fmt = named_format(fmt_name)
    for paged in (True, False):
        kv_write_bitwise(dev, g, fmt, paged, K=K, hd=hd)
    kv_write_bitwise(dev, g, fmt, True, K=K, hd=hd, collide=True)
    cache, k, v, pos, pages = kv_write_inputs(dev, g, fmt, True, K=K, hd=hd)
    fn = lambda: A._paged_cache_write(cache, k, v, pos, pages)
    r = dict(ms=cuda_ms(fn, iters=200), bound_ms=bound_ms(cost.nbytes(
        "kv_write", k, v, cache, pos, pages)),
        plain_ms=cuda_ms(lambda: Q.kv_write_plain(k, v, cache, pos, pages),
                         iters=10))
    r["device_ms"], r["kernels"] = device_ms_kernels(fn, iters=50)
    log(f"families : K={K:2d} hd={hd:3d} kv_write (paged decode layer "
        f"write) {r['ms']:.5f} ms (device {_ms(r['device_ms'])}; bound "
        f"{r['bound_ms']:.7f}, plain {r['plain_ms']:.3f}); bitwise in both "
        f"modes and with all 8 slots on one dump position")
    return r


def family_requests(vocab: int, n: int, *, seed=0, stagger=4, max_new=32):
    """Phase 5's workload shape: prompts of 16..256 tokens (numpy seed),
    ``max_new`` tokens each, one arrival every ``stagger`` decode steps (0:
    all at once)."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=u + 1,
                    tokens=rng.integers(0, vocab, int(rng.integers(16, 257))
                                        ).astype(np.int32),
                    max_new=max_new, arrival=stagger * u) for u in range(n)]


def moe_drops(tap, slots: int, k: int) -> dict:
    """Share of routed assignments that capacity dropped, in decode calls
    (``slots`` tokens) and in prefill calls, from moe_apply's load:
    dropped = sum(max(load - cap, 0))."""
    import torch

    if not tap:
        return {}
    loads = torch.stack([load for _, load in tap])
    caps = torch.tensor([c for c, _ in tap], dtype=loads.dtype,
                        device=loads.device)
    drop = torch.clamp(loads - caps[:, None], min=0).sum(1).cpu()
    tot = loads.sum(1).cpu()
    dec = tot == slots * k
    out = {}
    for name, m in (("decode", dec), ("prefill", ~dec)):
        n = float(tot[m].sum())
        out[name] = dict(assignments=int(n), dropped=int(drop[m].sum()),
                         share=float(drop[m].sum()) / n if n else None,
                         calls=int(m.sum()))
    return out


def family_run(dev, cfg, model, reqs, tag, **bs) -> dict:
    """One BatchedEngine run: every request finished with its max_new
    tokens, B3's KV write launched once per attention layer per decode step
    and per prefill call (never, without attention); the launches of the
    run, tok/s (wall, prefill included), the peak of
    max_memory_allocated, TTFT / TBT and the MoE drop shares."""
    import torch

    from repro_torch.kernels import cuda as C
    from repro_torch.models.moe import MoE, capacity
    from repro_torch.serve import BatchedEngine, BatchedServeConfig

    eng = BatchedEngine(cfg, BatchedServeConfig(**bs), model)
    before = dict(C.LAUNCHES)
    tap = []   # (cap, load) of every MoE call, from forward hooks

    def on_moe(mod, args, out):
        x, mcfg = args
        tap.append((capacity(x.shape[0] * x.shape[1], mcfg), out[1]["load"]))

    hooks = [m.register_forward_hook(on_moe) for m in model.modules()
             if isinstance(m, MoE)]
    sync(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    try:
        out = eng.run(reqs)
        sync(dev)
        dt = time.perf_counter() - t
    finally:
        for h in hooks:
            h.remove()
    counts = {k: C.LAUNCHES[k] - before.get(k, 0) for k in C.LAUNCHES}
    assert sorted(out) == sorted(r.uid for r in reqs), f"{tag}: lost requests"
    for r in reqs:
        o = out[r.uid]
        assert len(o) == r.max_new, f"{tag}: request {r.uid} short"
        assert ((o >= 0) & (o < cfg.vocab_size)).all()
    st = eng.stats
    attn_layers = len(cfg.attn_positions) * cfg.n_groups
    writes = attn_layers * (st["steps"] + st.get("prefill_calls", 0))
    assert counts["kv_write"] == writes, \
        f"{tag}: {counts['kv_write']} kv_write launches, not {writes}"
    ntok = sum(len(v) for v in out.values())
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if torch.device(dev).type == "cuda" else None)
    drops = moe_drops(tap, bs["slots"], cfg.experts_per_token)
    log(f"families : {cfg.name} {tag}: {len(out)} requests, {ntok} tokens in "
        f"{dt:.2f} s = {ntok / dt:.1f} tok/s; {st['rounds']} rounds, "
        f"{st.get('prefill_calls', 0)} prefill calls, peak "
        f"{_ms(peak)} GB; launches " + str({k: v for k, v in counts.items()
                                            if v}))
    for name, d in drops.items():
        log(f"families : {cfg.name} {tag}: {name} drops {d['dropped']} of "
            f"{d['assignments']} routed assignments ({d['share']:.4f}) over "
            f"{d['calls']} MoE calls")
    return dict(out=out, counts=counts, tok_s=ntok / dt, seconds=dt,
                stats=st, peak_gb=peak, drops=drops, engine=eng,
                latency=engine_latency(f"{cfg.name} {tag}", eng))


def _same_tokens(a: dict, b: dict) -> int:
    """Requests whose tokens agree, bitwise."""
    import numpy as np

    return sum(bool(np.array_equal(a[u], b[u])) for u in a)


def scout_phase(dev) -> dict:
    """10(b): llama4-scout at full width, 8 of 48 layers, random weights
    from seed 0, on phase 5's workload (slots 8, max_seq 1024, 8-token
    pages): paged, copy-in, paged again (run == rerun asserted), then all 8
    slots live from first to last step (8 requests at once, 32 tokens
    each: paged == copy-in asserted), the unfused Engine (B4, 4 tokens) and
    a profiled paged run. The launch counts are zeroed before the paged run
    and read after the unfused Engine: phase 10's main path."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import full_config
    from repro_torch.kernels import cuda as C
    from repro_torch.models import init_params
    from repro_torch.serve import Engine, ServeConfig

    cfg = dataclasses.replace(full_config("llama4_scout_17b"),
                              n_layers=SCOUT_LAYERS)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    sync(dev)
    log(f"families : {cfg.name} {cfg.n_layers}L d={cfg.d_model} "
        f"H={cfg.n_heads}/{cfg.n_kv_heads} E={cfg.n_experts} top-"
        f"{cfg.experts_per_token} + {cfg.n_shared_experts} shared ff="
        f"{cfg.d_ff} V={cfg.vocab_size} {cfg.dtype}, "
        f"{cfg.param_count() / 1e9:.2f}B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = family_requests(cfg.vocab_size, 16)
    bs = dict(slots=8, max_seq=1024)
    family_run(dev, cfg, model, reqs, "warm-up (paged)", **bs)
    C.reset_launches()
    paged = family_run(dev, cfg, model, reqs, "paged", **bs)
    copy_in = family_run(dev, cfg, model, reqs, "copy-in",
                         paged_decode=False, **bs)
    rerun = family_run(dev, cfg, model, reqs, "paged again", **bs)
    assert _same_tokens(paged["out"], rerun["out"]) == len(reqs), \
        "scout: paged run != its rerun"
    agree = _same_tokens(paged["out"], copy_in["out"])
    log(f"families : scout: paged == rerun, token for token; paged == "
        f"copy-in on {agree}/{len(reqs)} requests (staggered: idle slots "
        f"read other KV in the two modes and take expert capacity; "
        f"printed, not asserted)")
    full = family_requests(cfg.vocab_size, 8, seed=1, stagger=0)
    full_p = family_run(dev, cfg, model, full, "all slots live, paged", **bs)
    full_c = family_run(dev, cfg, model, full, "all slots live, copy-in",
                        paged_decode=False, **bs)
    assert _same_tokens(full_p["out"], full_c["out"]) == len(full), \
        "scout: paged != copy-in with every slot live"
    log("families : scout: paged == copy-in, token for token, with all 8 "
        "slots live")
    eng = Engine(cfg, ServeConfig(batch=1, max_seq=1024, quantized_kv=True),
                 model)
    before = dict(C.LAUNCHES)
    short = eng.generate(reqs[0].tokens[None], 4)
    sync(dev)
    reads = C.LAUNCHES["kv_read"] - before["kv_read"]
    assert reads == cfg.n_layers * 3, f"unfused scout: {reads} kv_read"
    assert short.shape == (1, 4)
    launches = dict(C.LAUNCHES)
    for name in ("attention_paged", "attention_packed", "kv_write",
                 "kv_read"):
        assert launches[name] > 0, f"phase 10 never launched {name}"
    prof = (profile_decode(cfg, model, bs)
            if torch.device(dev).type == "cuda" else None)
    res = dict(arch=cfg.name, layers=cfg.n_layers,
               params=cfg.param_count(), launches=launches,
               agree_copy_in=f"{agree}/{len(reqs)}", profile=prof)
    for tag, r in (("paged", paged), ("copy_in", copy_in),
                   ("rerun", rerun), ("live_paged", full_p),
                   ("live_copy_in", full_c)):
        res[tag] = {k: r[k] for k in ("tok_s", "seconds", "peak_gb",
                                      "drops", "latency")}
        res[tag]["rounds"] = r["stats"]["rounds"]
    res["pool"] = paged["stats"]["pool"]
    del model
    return res


def maverick_phase(dev) -> dict:
    """10(c): llama4-maverick at full width, 2 of 48 layers (one pattern
    group: a dense and a 128-expert layer), kv/b0 -> f2p_sr_2_8s and kv/b1
    -> f2p_lr_1_6s: 4 requests x 16 tokens at once on 4 slots, paged ==
    copy-in, each position's slabs in its own format."""
    import dataclasses

    from repro_torch.autotune import FormatPolicy, PolicyRule
    from repro_torch.configs import full_config
    from repro_torch.core.formats import named_format
    from repro_torch.models import init_params

    cfg = dataclasses.replace(full_config("llama4_maverick_400b"),
                              n_layers=MAVERICK_LAYERS)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    sync(dev)
    log(f"families : {cfg.name} {cfg.n_layers}L E={cfg.n_experts}, "
        f"{cfg.param_count() / 1e9:.2f}B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    pol = FormatPolicy(rules=(PolicyRule("kv/b0", "f2p_sr_2_8s", 0),
                              PolicyRule("kv/b1", "f2p_lr_1_6s", 0)))
    reqs = family_requests(cfg.vocab_size, 4, seed=2, stagger=0, max_new=16)
    bs = dict(slots=4, max_seq=1024, kv_policy=pol)
    paged = family_run(dev, cfg, model, reqs, "paged", **bs)
    copy_in = family_run(dev, cfg, model, reqs, "copy-in",
                         paged_decode=False, **bs)
    assert _same_tokens(paged["out"], copy_in["out"]) == len(reqs), \
        "maverick: paged != copy-in"
    want = {"b0": named_format("f2p_sr_2_8s"), "b1": named_format(
        "f2p_lr_1_6s")}
    pool = paged["engine"].pool
    per = {}
    for key, fmt in want.items():
        for kv in ("k", "v"):
            assert pool.slabs[key][kv].fmt == fmt, (key, kv)
            assert copy_in["engine"].caches[key][kv].fmt == fmt, (key, kv)
        per[key] = sum(pool.slabs[key][kv].nbytes for kv in ("k", "v"))
    st = pool.stats()
    log(f"families : maverick: paged == copy-in, token for token; pool "
        f"{st['pool_bytes_packed']} B ({per['b0']} B for b0 at 8 bits, "
        f"{per['b1']} B for b1 at 6 bits), {st['page_bytes_packed']} B per "
        f"page")
    del model
    return dict(arch=cfg.name, layers=cfg.n_layers, params=cfg.param_count(),
                pool=st, pool_bytes_by_position=per,
                paged={k: paged[k] for k in ("tok_s", "seconds", "peak_gb",
                                             "drops", "latency")},
                copy_in_tok_s=copy_in["tok_s"])


def minicpm3_phase(dev) -> dict:
    """10(d): minicpm3-4b at full width, not cut (62 layers, 40 kv heads =
    MHA, head_dim 64): 8 requests x 16 tokens at once, paged == copy-in."""
    from repro_torch.configs import full_config
    from repro_torch.models import init_params

    cfg = full_config("minicpm3_4b")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    sync(dev)
    log(f"families : {cfg.name} {cfg.n_layers}L d={cfg.d_model} "
        f"H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.head_dim}, "
        f"{cfg.param_count() / 1e9:.2f}B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = family_requests(cfg.vocab_size, 8, seed=3, stagger=0, max_new=16)
    bs = dict(slots=8, max_seq=1024)
    paged = family_run(dev, cfg, model, reqs, "paged", **bs)
    copy_in = family_run(dev, cfg, model, reqs, "copy-in",
                         paged_decode=False, **bs)
    assert _same_tokens(paged["out"], copy_in["out"]) == len(reqs), \
        "minicpm3: paged != copy-in"
    log("families : minicpm3: paged == copy-in, token for token")
    del model
    return dict(arch=cfg.name, layers=cfg.n_layers, params=cfg.param_count(),
                paged={k: paged[k] for k in ("tok_s", "seconds", "peak_gb",
                                             "latency")},
                copy_in_tok_s=copy_in["tok_s"])


def families_phase(dev) -> dict:
    """Phase 10: B1/B2/B3 at the new configs' shapes, then scout, maverick
    and minicpm3 at full width (each model freed before the next), then
    scout and maverick smoke on the card against the CPU."""
    import gc

    import torch

    t0 = time.perf_counter()
    kern = {}
    for K, G, hd in FAMILY_SHAPES:
        kern[f"K={K} G={G} hd={hd}"] = dict(
            attention_at(dev, K, G, hd), kv_write=kv_write_at(dev, K, hd))
    res = dict(kernels=kern)
    for name, fn in (("scout", scout_phase), ("maverick", maverick_phase),
                     ("minicpm3", minicpm3_phase)):
        res[name] = fn(dev)
        gc.collect()
        torch.cuda.empty_cache()
    res["small"] = {a: check_small(dev, a, tol=1e-4, steps=8, tokens=True)
                    for a in ("llama4_scout_17b", "llama4_maverick_400b")}
    sc = res["scout"]["launches"]
    # phase 10's main path (scout's runs): B1, B2, B3 (its KV write mode),
    # B4 (its K+V read mode)
    res["launches"] = {
        "attention_paged": sc["attention_paged"],
        "attention_packed": sc["attention_packed"],
        "quantize_packed": sc["kv_write"] + sc["quantize_packed"],
        "dequantize_packed": sc["kv_read"] + sc["dequantize_packed"]}
    res["seconds"] = time.perf_counter() - t0
    log(f"families : phase 10 in {res['seconds']:.1f} s; main-path launches "
        f"{res['launches']}")
    return res


def families_summary(fam: dict) -> dict:
    def brief(r):
        return {k: r.get(k) for k in ("tok_s", "peak_gb", "drops")} | {
            "ttft_p50_ms": r["latency"]["ttft_ms"]["p50"],
            "tbt_p50_ms": r["latency"]["tbt_ms"]["p50"],
            "tbt_p99_ms": r["latency"]["tbt_ms"]["p99"]}

    sc = fam["scout"]
    prof = sc.get("profile") or {}
    return dict(
        kernels={s: {k: {f: v.get(f) for f in ("ms", "device_ms",
                                                 "bound_ms", "max_abs_err")}
                     for k, v in r.items()} for s, r in fam["kernels"].items()},
        scout=dict(paged=brief(sc["paged"]), copy_in=brief(sc["copy_in"]),
                   live_paged=brief(sc["live_paged"]),
                   agree_copy_in=sc["agree_copy_in"],
                   device_busy_share=prof.get("device_busy_share")),
        maverick=dict(paged=brief(fam["maverick"]["paged"]),
                      pool_bytes_by_position=fam["maverick"][
                          "pool_bytes_by_position"]),
        minicpm3=dict(tok_s=fam["minicpm3"]["paged"]["tok_s"],
                      copy_in_tok_s=fam["minicpm3"]["copy_in_tok_s"]),
        small=fam["small"], launches=fam["launches"],
        seconds=fam["seconds"])


# ---------------------------------------------------------------------------
# phase 11: the recurrent families (jamba, xLSTM)
# ---------------------------------------------------------------------------
def _preempting_engine(victim: int, after: int):
    """A BatchedEngine that preempts request ``victim`` once, at the end of
    round ``after`` (the engine's own preempt hook: its state and KV go to
    the host and the next admission pass readmits it)."""
    from repro_torch.serve import BatchedEngine

    class Preempting(BatchedEngine):
        preempted = False

        def _harvest(self, chunk, results):
            super()._harvest(chunk, results)
            if (not self.preempted and self._c_rounds.exact == after
                    and any(st is not None and st.uid == victim
                            for st in self.slots)):
                self.preempt(victim)
                self.preempted = True

    return Preempting


def decode_breakdown(dev, cfg, model, slots=8, prompt=64, steps=8, *,
                     max_seq=1024, kv_policy=None, prefill_kw=None,
                     cross_kv=None, tag="recurrent") -> dict:
    """Where a decode step's time goes, with no admission in the way:
    ``slots`` rows prefilled with ``prompt`` random tokens (and
    ``prefill_kw``: an encoder's ``frames``, a vision prefix's
    ``patches``) into dense packed caches of ``max_seq`` positions in
    ``kv_policy``'s formats, prefill timed; then ``steps`` decode steps
    (``cross_kv`` passed to each) timed each with CUDA events and in all
    with the host clock (the device synchronised), and ``steps`` more
    profiled: ms per step, tok/s over every timed step, the device's busy
    share, device kernels per step and device ms by group, beside the
    weight bytes a step must read (every parameter but an encoder's,
    ``vision_proj`` and the embedding rows an untied model does not
    gather) over 3.35 TB/s."""
    import dataclasses
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step, init_caches, prefill

    cfg = dataclasses.replace(cfg, fused_attention=True)
    prefill_kw = prefill_kw or {}
    cuda = torch.device(dev).type == "cuda"
    g = torch.Generator().manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (slots, prompt),
                         generator=g).to(dev)
    caches = init_caches(cfg, slots, max_seq, quantized_kv=True,
                         kv_policy=kv_policy, device=dev)
    sync(dev)
    t = time.perf_counter()
    logits = prefill(model, toks, caches, cfg=cfg, **prefill_kw)
    sync(dev)
    prefill_ms = 1e3 * (time.perf_counter() - t)
    tok = torch.argmax(logits, -1)[:, None]
    pos = pos0 = prompt + (prefill_kw["patches"].shape[1]
                           if "patches" in prefill_kw else 0)

    def run(n, timed=False):
        nonlocal tok, pos
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
              if timed and cuda else [])
        for i in range(n):
            if ev:
                ev[i].record()
            tok = torch.argmax(decode_step(model, tok, pos, caches, cfg=cfg,
                                           cross_kv=cross_kv), -1)[:, None]
            pos += 1
        if ev:
            ev[n].record()
        return ev

    run(2)
    sync(dev)
    t = time.perf_counter()
    ev = run(steps, timed=True)
    sync(dev)
    ms = 1e3 * (time.perf_counter() - t) / steps
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1)]
    nbytes = sum(p.numel() * p.element_size()
                 for n, p in model.named_parameters()
                 if not n.startswith(("encoder.", "vision_proj")))
    if model.lm_head is not None:
        nbytes -= model.embed.numel() * model.embed.element_size()
    out = dict(prefill_ms=prefill_ms, ms_per_step=ms, step_ms=step_ms,
               median_step_ms=statistics.median(step_ms) if step_ms else None,
               tok_s=slots / ms * 1e3, weight_bytes=nbytes,
               bound_ms=bound_ms(nbytes))
    if cuda:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run(steps)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
        res = device_profile(prof, wall_us, ("attention_decode_kernel",
                                             "quantize_packed"))
        n_dev = sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        out.update(device_busy_share=res["device_busy_share"],
                   device_kernels_per_step=n_dev / steps,
                   groups_ms_per_step={k: v / steps for k, v in
                                       res["groups_ms"].items()})
    log(f"{tag:9s}: {cfg.name} decode alone ({slots} rows at position "
        f"{pos0}+, prefill {prefill_ms:.2f} ms): {ms:.2f} ms "
        f"per step (median {_ms(out['median_step_ms'])}), "
        f"{out['tok_s']:.2f} tok/s, against a {out['bound_ms']:.3f} ms "
        f"weight-read bound ({nbytes / 1e9:.2f} GB); busy "
        f"{_ms(out.get('device_busy_share'))}, "
        f"{out.get('device_kernels_per_step')} device kernels per step, "
        f"device ms per step by group "
        f"{ {k: round(v, 3) for k, v in out.get('groups_ms_per_step', {}).items()} }")
    return out


def xlstm_serve_phase(dev):
    """11(b): xLSTM-125m, full (12 layers, no pool): phase 5's staggered
    workload run twice (run == rerun asserted), a run that preempts request
    1 after 2 rounds (its tokens == the uninterrupted run's, asserted), no
    KV kernel launched; the sequential Engine's agreement (printed) and a
    profiled run. Returns (results, (cfg, model)): the model stays for the
    decode breakdown, which runs off the main path."""
    import numpy as np
    import torch

    from repro_torch.configs import full_config
    from repro_torch.kernels import cuda as C
    from repro_torch.models import init_params
    from repro_torch.serve import BatchedServeConfig, Engine, ServeConfig

    cfg = full_config("xlstm_125m")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    sync(dev)
    log(f"recurrent: {cfg.name} {cfg.n_layers}L d={cfg.d_model} "
        f"H={cfg.n_heads} V={cfg.vocab_size} tied {cfg.tie_embeddings} "
        f"{cfg.dtype}, {cfg.param_count() / 1e9:.3f}B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = family_requests(cfg.vocab_size, 16)
    bs = dict(slots=8, max_seq=1024)
    before = dict(C.LAUNCHES)
    run = family_run(dev, cfg, model, reqs, "run", **bs)
    rerun = family_run(dev, cfg, model, reqs, "rerun", **bs)
    assert _same_tokens(run["out"], rerun["out"]) == len(reqs), \
        "xLSTM: run != rerun"
    victim = reqs[0].uid
    eng = _preempting_engine(victim, 2)(cfg, BatchedServeConfig(**bs), model)
    pre = eng.run(reqs)
    sync(dev)
    assert eng.preempted and eng.stats.get("readmits", 0) == 1
    assert np.array_equal(pre[victim], run["out"][victim]), \
        "xLSTM: the preempted request's tokens changed"
    pre_same = _same_tokens(run["out"], pre)
    kv = {k: C.LAUNCHES[k] - before[k] for k in (
        "attention_paged", "attention_packed", "kv_write", "kv_read",
        "quantize_packed", "dequantize_packed")}
    assert not any(kv.values()), f"xLSTM launched KV kernels: {kv}"
    state_b = run["engine"].state_bytes_per_slot()
    log(f"recurrent: xLSTM run == rerun, token for token; request {victim} "
        f"preempted after round 2 (state to the host and back) gives its "
        f"tokens ({pre_same}/{len(reqs)} requests equal); no KV kernel "
        f"launched; recurrent state {state_b} B per slot")
    seq = Engine(cfg, ServeConfig(batch=1, max_seq=1024), model)
    agree = sum(bool(np.array_equal(
        seq.generate(r.tokens[None], r.max_new)[0].astype(np.int32),
        run["out"][r.uid])) for r in reqs)
    log(f"recurrent: xLSTM sequential Engine == batched on {agree}/"
        f"{len(reqs)} requests (printed, not asserted: cuBLAS may sum "
        f"batch-1 and batch-8 products in other orders at bf16)")
    prof = (profile_decode(cfg, model, bs)
            if torch.device(dev).type == "cuda" else None)
    res = dict(arch=cfg.name, layers=cfg.n_layers, params=cfg.param_count(),
               state_bytes_per_slot=state_b, preempted_equal=pre_same,
               sequential_agree=f"{agree}/{len(reqs)}", profile=prof)
    for tag, r in (("run", run), ("rerun", rerun)):
        res[tag] = {k: r[k] for k in ("tok_s", "seconds", "peak_gb",
                                      "latency")}
        res[tag]["rounds"] = r["stats"]["rounds"]
    return res, (cfg, model)


def xlstm_train_phase(dev) -> dict:
    """11(d): the train CLI's default arch (xlstm_125m, --full) with its
    optimizer, compression and data configs: XLSTM_TRAIN_STEPS steps of
    batch 8 x seq 128 with F2P8 gradients; one round-trip launch per step,
    no per-leaf B5 / B6 launch (asserted), finite losses. The compressed
    leaves are those whose stacked reference leaf (the layer's size times
    the pattern's groups) holds ``min_size`` elements (asserted), and step
    0's gradients and residuals equal the plain round trip on each leaf's
    g and r as autograd hands them over, bitwise (asserted), as phase 8
    holds them at llama3.2-3b's leaves."""
    import torch

    from repro_torch.configs import full_config
    from repro_torch.data import host_batch
    from repro_torch.kernels import cuda as C
    from repro_torch.launch.train import parse_args
    from repro_torch.launch.train import train_configs as cli_configs
    from repro_torch.train import init_train_state, make_train_step

    arch = parse_args([]).arch
    assert arch == "xlstm_125m", f"the train CLI defaults to {arch}"
    cfg = full_config(arch)
    ocfg, ccfg, dcfg, _ = cli_configs(cfg, arch=arch,
                                      steps=XLSTM_TRAIN_STEPS,
                                      global_batch=TRAIN_BATCH,
                                      seq=TRAIN_SEQ)
    state = init_train_state(cfg, ocfg, ccfg, seed=0, device=dev)
    model, res = state["params"], state["residuals"]
    n_comp = sum(r is not None for r in res.values())
    stacked = {n: p.numel() * (cfg.n_groups if n.startswith("blocks.") else 1)
               for n, p in model.named_parameters()}
    assert {n for n, r in res.items() if r is not None} == \
        {n for n, k in stacked.items() if k >= ccfg.min_size}, \
        "xLSTM: the compressed leaves are not those of the stacked sizes"
    step0 = Step0RoundTrip(model, res, ccfg)
    step_fn = make_train_step(cfg, ocfg, ccfg)
    losses, step_ms = [], []
    for step in range(XLSTM_TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in host_batch(dcfg, step).items()}
        before = dict(C.LAUNCHES)
        sync(dev)
        t = time.perf_counter()
        state, m = step_fn(state, batch)
        loss = float(m["loss"])
        sync(dev)
        step_ms.append(1e3 * (time.perf_counter() - t))
        losses.append(loss)
        n = {k: C.LAUNCHES[k] - before[k] for k in ("ef_roundtrip",
                                                    "quantize", "dequantize")}
        assert math.isfinite(loss), f"xLSTM step {step}: loss {loss}"
        assert n == {"ef_roundtrip": 1, "quantize": 0, "dequantize": 0}, \
            f"xLSTM step {step}: launches {n} ({n_comp} leaves)"
        if step == 0:
            assert step0.check("xLSTM step 0") == n_comp
            log(f"recurrent: xLSTM step 0 compressed gradients and residuals "
                f"== plain round trip on g + r, bitwise, all {n_comp} leaves "
                f"(stacked by the {len(cfg.pattern)}-position pattern)")
        log(f"recurrent: xLSTM train step {step} loss {loss:.4f} "
            f"{step_ms[-1]:.1f} ms, 1 round-trip launch ({n_comp} leaves)")
    del state, model, res, step_fn
    return dict(arch=cfg.name, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                losses=losses, step_ms=step_ms, compressed_leaves=n_comp)


def jamba_phase(dev):
    """11(c): jamba at full width, one pattern group (8 layers: 1 attention,
    7 mamba, 4 dense and 4 MoE FFs) with 8 of its 16 experts: 8 requests x
    32 tokens at once on 8 slots, paged, copy-in and paged again (paged ==
    copy-in == rerun asserted; every slot is live from the first decode step
    to the last), B1 on the paged and B2 on the copy-in runs, a profiled
    run. Returns (results, (cfg, model)), as :func:`xlstm_serve_phase`."""
    import dataclasses

    import torch

    from repro_torch.configs import full_config
    from repro_torch.models import init_params

    full = full_config("jamba_1_5_large")
    group = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    cfg = dataclasses.replace(group, n_experts=JAMBA_EXPERTS)
    log(f"recurrent: jamba cut to {JAMBA_LAYERS} layers (one pattern group) "
        f"and {JAMBA_EXPERTS} of {full.n_experts} experts: one group with "
        f"{full.n_experts} is {group.param_count() * 2 / 1e9:.1f} GB in bf16, "
        f"with {JAMBA_EXPERTS} {cfg.param_count() * 2 / 1e9:.1f} GB, against "
        f"the card's 80 (the cut changes the routing, not a width)")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    sync(dev)
    log(f"recurrent: {cfg.name} {cfg.n_layers}L d={cfg.d_model} "
        f"H={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} d_inner="
        f"{cfg.d_inner} state {cfg.ssm_state} conv {cfg.ssm_conv} "
        f"E={cfg.n_experts} top-{cfg.experts_per_token} V={cfg.vocab_size} "
        f"{cfg.dtype}, {cfg.param_count() / 1e9:.2f}B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = family_requests(cfg.vocab_size, 8, seed=4, stagger=0)
    bs = dict(slots=8, max_seq=1024)
    paged = family_run(dev, cfg, model, reqs, "paged", **bs)
    copy_in = family_run(dev, cfg, model, reqs, "copy-in",
                         paged_decode=False, **bs)
    rerun = family_run(dev, cfg, model, reqs, "paged again", **bs)
    assert _same_tokens(paged["out"], copy_in["out"]) == len(reqs), \
        "jamba: paged != copy-in with every slot live"
    assert _same_tokens(paged["out"], rerun["out"]) == len(reqs), \
        "jamba: paged != its rerun"
    assert paged["counts"]["attention_paged"] > 0
    assert copy_in["counts"]["attention_packed"] > 0
    pool = paged["engine"].pool
    st = pool.stats()
    slot_kv = st["page_bytes_packed"] * (bs["max_seq"] // pool.page_tokens)
    state_b = paged["engine"].state_bytes_per_slot()
    log(f"recurrent: jamba paged == copy-in == rerun, token for token; "
        f"pool {st['pool_bytes_packed']} B ({st['page_bytes_packed']} B per "
        f"page, {slot_kv} B for a slot's {bs['max_seq']} positions); "
        f"recurrent state {state_b} B per slot")
    prof = (profile_decode(cfg, model, bs)
            if torch.device(dev).type == "cuda" else None)
    res = dict(arch=cfg.name, layers=cfg.n_layers,
               experts=f"{cfg.n_experts} of {full.n_experts}",
               params=cfg.param_count(), pool=st, slot_kv_bytes=slot_kv,
               state_bytes_per_slot=state_b, profile=prof)
    for tag, r in (("paged", paged), ("copy_in", copy_in),
                   ("rerun", rerun)):
        res[tag] = {k: r[k] for k in ("tok_s", "seconds", "peak_gb",
                                      "drops", "latency", "counts")}
        res[tag]["rounds"] = r["stats"]["rounds"]
    return res, (cfg, model)


def recurrent_phase(dev) -> dict:
    """Phase 11: B1/B2/B3 at jamba's attention shape; then the main path
    with the launch counts zeroed first and read last: xLSTM-125m served,
    xLSTM trained by the CLI's default, jamba served; then, off the main
    path, each served model's decode breakdown (prefill and decode_step on
    dense caches, outside the engine) and the smoke configs on the card
    against the CPU."""
    import gc

    import torch

    from repro_torch.kernels import cuda as C

    t0 = time.perf_counter()
    K, G, hd = RECURRENT_SHAPE
    res = dict(kernels=dict(attention_at(dev, K, G, hd),
                            kv_write=kv_write_at(dev, K, hd)))

    def collect():
        gc.collect()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()

    C.reset_launches()
    res["xlstm"], xl = xlstm_serve_phase(dev)
    collect()
    res["train"] = xlstm_train_phase(dev)
    collect()
    res["jamba"], jb = jamba_phase(dev)
    sc = dict(C.LAUNCHES)
    collect()
    for name, (cfg, model) in (("jamba", jb), ("xlstm", xl)):
        res[name]["decode"] = decode_breakdown(dev, cfg, model)
    del xl, jb, cfg, model
    collect()
    res["launches"] = {
        "attention_paged": sc["attention_paged"],
        "attention_packed": sc["attention_packed"],
        "quantize_packed": sc["kv_write"] + sc["quantize_packed"],
        "ef_roundtrip": sc["ef_roundtrip"]}
    for name, n in res["launches"].items():
        assert n > 0, f"phase 11 never launched {name}"
    res["small"] = {a: check_small(dev, a, tol=1e-4, steps=8, tokens=True)
                    for a in ("jamba_1_5_large", "xlstm_125m")}
    res["seconds"] = time.perf_counter() - t0
    log(f"recurrent: phase 11 in {res['seconds']:.1f} s; main-path launches "
        f"{res['launches']}")
    return res


def recurrent_summary(rec: dict) -> dict:
    def brief(r):
        return {k: r.get(k) for k in ("tok_s", "peak_gb", "drops")} | {
            "ttft_p50_ms": r["latency"]["ttft_ms"]["p50"],
            "ttft_p99_ms": r["latency"]["ttft_ms"]["p99"],
            "tbt_p50_ms": r["latency"]["tbt_ms"]["p50"],
            "tbt_p99_ms": r["latency"]["tbt_ms"]["p99"]}

    def busy(r):
        return (r.get("profile") or {}).get("device_busy_share")

    xl, jb = rec["xlstm"], rec["jamba"]
    return dict(
        kernels={k: {f: v.get(f) for f in ("ms", "device_ms", "bound_ms",
                                           "max_abs_err")}
                 for k, v in rec["kernels"].items()},
        xlstm=dict(run=brief(xl["run"]), busy_share=busy(xl),
                   decode=xl["decode"],
                   state_bytes_per_slot=xl["state_bytes_per_slot"],
                   sequential_agree=xl["sequential_agree"]),
        train=dict(losses=rec["train"]["losses"],
                   step_ms=rec["train"]["step_ms"]),
        jamba=dict(paged=brief(jb["paged"]), copy_in=brief(jb["copy_in"]),
                   busy_share=busy(jb), experts=jb["experts"],
                   decode=jb["decode"],
                   pool_bytes=jb["pool"]["pool_bytes_packed"],
                   slot_kv_bytes=jb["slot_kv_bytes"],
                   state_bytes_per_slot=jb["state_bytes_per_slot"]),
        small=rec["small"], launches=rec["launches"],
        seconds=rec["seconds"])


# ---------------------------------------------------------------------------
# phase 12: the two frontend archs (whisper, internvl2)
# ---------------------------------------------------------------------------
def slabs_from_dense(cfg, caches, pol, B, T, dev, seed=12):
    """Pool slabs holding the dense caches' pages at a permutation (as
    tests/test_torch_families.py builds them): (slabs, page table). Rows
    of ``caches`` are ``max_seq = maxp * T`` positions. A recurrent
    position of the pattern gets a fresh zero state."""
    import torch

    from repro_torch.models import init_caches

    S = next(c for c in caches.values() if "k" in c)["k"].shape[2]
    maxp = S // T
    P = B * maxp + 2
    slabs = init_caches(cfg, 1, P * T, quantized_kv=True, kv_policy=pol,
                        device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(P, generator=g, device=dev)
    pages = perm[:B * maxp].reshape(B, maxp).to(torch.int32)
    G, K = cfg.n_groups, cfg.n_kv_heads
    idx = pages.flatten().long()
    for key in caches:
        if "k" not in caches[key]:
            continue
        for kv in ("k", "v"):
            src, dst = caches[key][kv], slabs[key][kv]
            W = src.codes.shape[-1]
            codes = dst.codes.view(torch.int32).reshape(G, P, T, K, W)
            scales = dst.scales.reshape(G, P, T, K, 1)
            codes[:, idx] = src.codes.view(torch.int32).reshape(
                G, B * maxp, T, K, W)
            scales[:, idx] = src.scales.reshape(G, B * maxp, T, K, 1)
            slabs[key][kv] = type(dst)(codes.view(torch.uint32), scales,
                                       dst.fmt, dst.block,
                                       (G, P, T, K, cfg.head_dim),
                                       packed=True)
    return slabs, pages


def _clone_caches(caches):
    return {key: _clone_cache(c) for key, c in caches.items()}


def greedy_decode(dev, model, cfg, caches, tok, pos, steps, *, pages=None,
                  cross_kv=None) -> dict:
    """``steps`` greedy decode steps from ``tok`` [B, 1] at per-slot
    positions ``pos`` [B]: each step's logits (kept on the device), the
    tokens [B, steps], each step's ms (CUDA events, no host sync inside the
    loop) and the kernel launches of the run."""
    import torch

    from repro_torch.kernels import cuda as C
    from repro_torch.models import decode_step

    cuda = torch.device(dev).type == "cuda"
    ev = ([torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
          if cuda else [])
    before = dict(C.LAUNCHES)
    logits, toks = [], []
    for i in range(steps):
        if cuda:
            ev[i].record()
        lg = decode_step(model, tok, pos + i, caches, pages=pages, cfg=cfg,
                         cross_kv=cross_kv)
        tok = torch.argmax(lg, -1)[:, None]
        logits.append(lg)
        toks.append(tok)
    if cuda:
        ev[steps].record()
    sync(dev)
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)] \
        if cuda else []
    return dict(logits=logits, tokens=torch.cat(toks, 1).cpu(),
                step_ms=step_ms,
                counts={k: C.LAUNCHES[k] - before.get(k, 0)
                        for k in C.LAUNCHES})


def _expect_launches(tag, counts, want) -> None:
    """Every kernel counter of the run equal to ``want``'s (0 where
    ``want`` does not name it)."""
    got = {k: v for k, v in counts.items() if v}
    assert got == want, f"{tag}: launches {got}, expected {want}"


def _run_summary(tag, run, rows) -> dict:
    """Median and first step ms, and tok/s over every step."""
    import statistics

    ms = run["step_ms"]
    med = statistics.median(ms) if ms else None
    tok_s = rows * len(ms) / (sum(ms) / 1e3) if ms else None
    first = ms[0] if ms else None
    log(f"frontend : {tag}: {len(run['logits'])} steps, median "
        f"{_ms(med)} ms per step (first {_ms(first)}), {_ms(tok_s)} tok/s "
        f"over all {len(ms)}; launches "
        f"{ {k: v for k, v in run['counts'].items() if v} }")
    return dict(median_step_ms=med, first_step_ms=first, tok_s=tok_s,
                step_ms=ms,
                launches={k: v for k, v in run["counts"].items() if v})


def whisper_phase(dev):
    """12(b): whisper-large-v3 at full width (32 encoder + 32 decoder
    layers, d 1280, random weights from seed 0, bf16): 4 rows of seeded
    1500-frame embeddings and a 4-token prompt; encode, prefill(frames=)
    into caches of WHISPER_MAX_SEQ positions in the default policy's KV
    format (f2p_sr_1_8s), then FRONTEND_STEPS greedy decode steps three
    ways from that one prefill: fused dense (B2 + B3), paged over slabs
    holding the prefill's pages at a permutation (B1 + B3; its logits
    equal the fused run's bitwise at every step, asserted) and unfused
    (B4 + B3; token agreement with the fused run printed). Each run's
    launches asserted: one attention kernel (or K+V read) and one KV write
    per layer per step. Returns (result, a call that breaks a fused decode
    step down with decode_breakdown, made after the main path's counts are
    read)."""
    import dataclasses

    import torch

    from repro_torch.configs import default_policy, full_config
    from repro_torch.core.formats import named_format
    from repro_torch.models import encode, init_caches, init_params, prefill

    cfg = dataclasses.replace(full_config("whisper_large_v3"),
                              fused_attention=True)
    pol = default_policy("whisper_large_v3")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    sync(dev)
    log(f"frontend : {cfg.name} {cfg.encoder_layers}+{cfg.n_layers}L "
        f"d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} hd="
        f"{cfg.head_dim} ff={cfg.d_ff} V={cfg.vocab_size} {cfg.dtype}, "
        f"{cfg.param_count() / 1e9:.3f}B params (reference count), init "
        f"{time.perf_counter() - t0:.1f} s")
    B, L, steps = WHISPER_ROWS, cfg.n_layers, FRONTEND_STEPS
    g = torch.Generator(device=dev).manual_seed(12)
    frames = torch.randn(B, cfg.encoder_seq, cfg.d_model, generator=g,
                         device=dev).to(cfg.torch_dtype)
    prompt = torch.randint(0, cfg.vocab_size, (B, WHISPER_PROMPT),
                           generator=g, device=dev)
    with torch.inference_mode():
        cross = encode(model, frames)
        enc_ms = host_ms(lambda: encode(model, frames), iters=1)
    assert cross.shape == (B, cfg.encoder_seq, cfg.d_model)
    assert bool(torch.isfinite(cross).all()), "whisper: encoder non-finite"
    caches = init_caches(cfg, B, WHISPER_MAX_SEQ, quantized_kv=True,
                         kv_policy=pol, device=dev)
    assert caches["b0"]["k"].fmt == named_format("f2p_sr_1_8s")
    logits = prefill(model, prompt, caches, frames=frames)
    assert logits.shape == (B, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), "whisper: prefill non-finite"
    slabs, pages = slabs_from_dense(cfg, caches, pol, B, 8, dev)
    unfused_caches = _clone_caches(caches)
    tok = torch.argmax(logits, -1)[:, None]
    pos = torch.full((B,), WHISPER_PROMPT, device=dev)
    log(f"frontend : whisper encode {enc_ms:.2f} ms ({B} x "
        f"{cfg.encoder_seq} frames)")
    fused = greedy_decode(dev, model, cfg, caches, tok, pos, steps,
                          cross_kv=cross)
    _expect_launches("whisper fused", fused["counts"],
                     {"attention_packed": L * steps, "kv_write": L * steps})
    paged = greedy_decode(dev, model, cfg, slabs, tok, pos, steps,
                          pages=pages, cross_kv=cross)
    _expect_launches("whisper paged", paged["counts"],
                     {"attention_paged": L * steps, "kv_write": L * steps})
    for i, (a, b) in enumerate(zip(fused["logits"], paged["logits"])):
        assert torch.equal(a, b), f"whisper: paged != fused at step {i}"
    ucfg = dataclasses.replace(cfg, fused_attention=False)
    unfused = greedy_decode(dev, model, ucfg, unfused_caches, tok, pos,
                            steps, cross_kv=cross)
    _expect_launches("whisper unfused", unfused["counts"],
                     {"kv_read": L * steps, "kv_write": L * steps})
    for run in (fused, unfused):
        assert all(bool(torch.isfinite(lg).all()) for lg in run["logits"])
    agree = int((unfused["tokens"] == fused["tokens"]).sum())
    log(f"frontend : whisper paged == fused logits, bitwise, at all "
        f"{steps} steps; unfused agrees with fused on {agree}/{B * steps} "
        "tokens (B4 + naive attention sum in another order: printed, not "
        "asserted; B4 is held bitwise at this shape in 12(a))")
    res = dict(arch=cfg.name, params=cfg.param_count(), encode_ms=enc_ms,
               unfused_agree=f"{agree}/{B * steps}",
               fused=_run_summary("whisper fused (B2 + B3)", fused, B),
               paged=_run_summary("whisper paged (B1 + B3)", paged, B),
               unfused=_run_summary("whisper unfused (B4 + B3)", unfused,
                                    B))
    return res, lambda: decode_breakdown(
        dev, cfg, model, B, WHISPER_PROMPT, 8, max_seq=WHISPER_MAX_SEQ,
        kv_policy=pol, prefill_kw=dict(frames=frames), cross_kv=cross,
        tag="frontend")


def internvl2_phase(dev):
    """12(c): internvl2-1b at full width (24 layers, d 896, 14 / 2 heads:
    G = 7), random weights from seed 0, bf16. Model level: 4 rows of
    VLM_PATCHES seeded patch embeddings + 32-token prompts prefilled into
    dense caches, then FRONTEND_STEPS fused and as many unfused decode
    steps from position VLM_PATCHES + 32 (launches asserted, one per layer
    per step). Then BatchedEngine, text only, paged and copy-in, 8
    staggered requests: tokens equal (llama-dense co-batches exactly).
    Returns (result, a call that breaks a fused decode step down)."""
    import dataclasses

    import torch

    from repro_torch.configs import default_policy, full_config
    from repro_torch.models import init_caches, init_params, prefill

    cfg = dataclasses.replace(full_config("internvl2_1b"),
                              fused_attention=True)
    assert cfg.vision_tokens == VLM_PATCHES
    pol = default_policy("internvl2_1b")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    sync(dev)
    log(f"frontend : {cfg.name} {cfg.n_layers}L d={cfg.d_model} "
        f"H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.head_dim} "
        f"V={cfg.vocab_size} {cfg.dtype}, {cfg.param_count() / 1e9:.3f}B "
        f"params, init {time.perf_counter() - t0:.1f} s")
    B, L, steps, P = VLM_ROWS, cfg.n_layers, FRONTEND_STEPS, VLM_PATCHES
    g = torch.Generator(device=dev).manual_seed(13)
    patches = torch.randn(B, P, cfg.d_model, generator=g,
                          device=dev).to(cfg.torch_dtype)
    prompt = torch.randint(0, cfg.vocab_size, (B, VLM_PROMPT), generator=g,
                           device=dev)
    caches = init_caches(cfg, B, VLM_MAX_SEQ, quantized_kv=True,
                         kv_policy=pol, device=dev)
    logits = prefill(model, prompt, caches, patches=patches)
    assert bool(torch.isfinite(logits).all()), "internvl2: non-finite"
    unfused_caches = _clone_caches(caches)
    tok = torch.argmax(logits, -1)[:, None]
    pos = torch.full((B,), P + VLM_PROMPT, device=dev)
    fused = greedy_decode(dev, model, cfg, caches, tok, pos, steps)
    _expect_launches("internvl2 fused", fused["counts"],
                     {"attention_packed": L * steps, "kv_write": L * steps})
    unfused = greedy_decode(dev, model, dataclasses.replace(
        cfg, fused_attention=False), unfused_caches, tok, pos, steps)
    _expect_launches("internvl2 unfused", unfused["counts"],
                     {"kv_read": L * steps, "kv_write": L * steps})
    agree = int((unfused["tokens"] == fused["tokens"]).sum())
    log(f"frontend : internvl2 ({P} patches + {VLM_PROMPT} tokens x {B} "
        f"rows); unfused agrees with fused on {agree}/{B * steps} tokens "
        "(printed, not asserted; B4 is held bitwise at this shape in 12(a))")
    res = dict(arch=cfg.name, params=cfg.param_count(),
               unfused_agree=f"{agree}/{B * steps}",
               fused=_run_summary("internvl2 fused (B2 + B3)", fused, B),
               unfused=_run_summary("internvl2 unfused (B4 + B3)", unfused,
                                    B))
    reqs = family_requests(cfg.vocab_size, 8, seed=4)
    bs = dict(slots=8, max_seq=1024)
    paged = family_run(dev, cfg, model, reqs, "text only, paged", **bs)
    copy_in = family_run(dev, cfg, model, reqs, "text only, copy-in",
                         paged_decode=False, **bs)
    assert _same_tokens(paged["out"], copy_in["out"]) == len(reqs), \
        "internvl2: paged != copy-in"
    assert paged["counts"]["attention_paged"] > 0
    assert copy_in["counts"]["attention_packed"] > 0
    log("frontend : internvl2 served text only: paged == copy-in, token for "
        "token")
    for tag, r in (("engine_paged", paged), ("engine_copy_in", copy_in)):
        res[tag] = {k: r[k] for k in ("tok_s", "seconds", "peak_gb",
                                      "latency")}
    return res, lambda: decode_breakdown(
        dev, cfg, model, B, VLM_PROMPT, 8, max_seq=VLM_MAX_SEQ,
        kv_policy=pol, prefill_kw=dict(patches=patches), tag="frontend")


def frontends_phase(dev) -> dict:
    """Phase 12: (a) B1/B2 at the two archs' kv shapes, f32 q over 8 x
    1024 positions and bf16 q at their own main-path rows, cache length
    and kv_len; B3 at their shapes; B4's K+V read of their unfused decode's
    layer cache. Then the main path, with the launch counts zeroed just
    before each arch and read just after it (its decode breakdown runs
    after the read): whisper, then internvl2 (each model freed before the
    next); then both smoke configs on the card against the CPU."""
    import gc

    import torch

    from repro_torch.kernels import cuda as C

    def collect():
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    kern = {}
    for K, G, hd, fmt, rows, max_seq, start in FRONTEND_SHAPES:
        # kv_len over the main path's decode steps: start + 1 .. start + steps
        kv = (start + 1, start + FRONTEND_STEPS)
        kern[f"K={K} G={G} hd={hd} {fmt}"] = dict(
            attention_at(dev, K, G, hd, fmt, tag="frontend"),
            main_path=attention_at(dev, K, G, hd, fmt, B=rows, S=max_seq,
                                   kv=kv, q_dtype="bfloat16",
                                   tag="frontend"),
            kv_write=kv_write_at(dev, K, hd, fmt),
            kv_read=kv_read_at(dev, K, hd, fmt, rows, max_seq))
    res = dict(kernels=kern)
    sc = {}
    for name, phase in (("whisper", whisper_phase),
                        ("internvl2", internvl2_phase)):
        C.reset_launches()
        res[name], breakdown = phase(dev)
        for k, v in C.LAUNCHES.items():
            sc[k] = sc.get(k, 0) + v
        res[name]["profile"] = breakdown()
        del breakdown
        collect()
    res["launches"] = {
        "attention_paged": sc["attention_paged"],
        "attention_packed": sc["attention_packed"],
        "quantize_packed": sc["kv_write"] + sc["quantize_packed"],
        "dequantize_packed": sc["kv_read"] + sc["dequantize_packed"]}
    for name, n in res["launches"].items():
        assert n > 0, f"phase 12 never launched {name}"
    res["small"] = {a: check_small(dev, a, tol=1e-3, steps=8, tokens=True)
                    for a in ("whisper_large_v3", "internvl2_1b")}
    res["seconds"] = time.perf_counter() - t0
    log(f"frontend : phase 12 in {res['seconds']:.1f} s; main-path launches "
        f"{res['launches']}")
    return res


def frontends_summary(fr: dict) -> dict:
    wh, vl = fr["whisper"], fr["internvl2"]

    def runs(r, names):
        return {n: {k: r[n][k] for k in ("median_step_ms", "first_step_ms",
                                         "tok_s")}
                for n in names}

    def breakdown(r):
        return {k: r["profile"].get(k) for k in (
            "prefill_ms", "median_step_ms", "tok_s", "bound_ms",
            "device_busy_share", "device_kernels_per_step",
            "groups_ms_per_step")}

    def rows(r):
        return {k: {f: v.get(f) for f in ("ms", "device_ms", "bound_ms",
                                          "max_abs_err", "shape")}
                for k, v in r.items()}

    return dict(
        kernels={s: dict(rows({k: v for k, v in r.items()
                               if k != "main_path"}),
                         main_path=rows(r["main_path"]))
                 for s, r in fr["kernels"].items()},
        whisper=dict(encode_ms=wh["encode_ms"],
                     unfused_agree=wh["unfused_agree"],
                     breakdown=breakdown(wh),
                     **runs(wh, ("fused", "paged", "unfused"))),
        internvl2=dict(unfused_agree=vl["unfused_agree"],
                       breakdown=breakdown(vl),
                       engine_paged_tok_s=vl["engine_paged"]["tok_s"],
                       engine_copy_in_tok_s=vl["engine_copy_in"]["tok_s"],
                       **runs(vl, ("fused", "unfused"))),
        small=fr["small"], launches=fr["launches"], seconds=fr["seconds"])


# ---------------------------------------------------------------------------
# phase 13: training the MoE family
# ---------------------------------------------------------------------------
def train_state_bytes(cfg, ccfg) -> dict:
    """The train state's bytes by the port's layout: each parameter and its
    gradient in its own dtype (the router f32, the rest ``cfg.dtype``), f32
    ``mu`` and ``nu``, and an f32 error-feedback residual for each leaf
    whose stacked reference size reaches ``ccfg.min_size``; beside it the
    f32 temporaries AdamW's update takes on the largest leaf (three)."""
    from repro_torch.models.convert import reference_numel
    from repro_torch.models.model import Model

    named = dict(Model(cfg, "meta").named_parameters())
    sizes = reference_numel(named, len(cfg.pattern))
    state = sum(p.numel() * (2 * p.element_size() + 8
                             + 4 * (sizes[n] >= ccfg.min_size))
                for n, p in named.items())
    largest = max(p.numel() for p in named.values())
    return dict(params=sum(p.numel() for p in named.values()),
                state=state, adamw_temporaries=3 * 4 * largest)


def check_restored(saved: dict, got: dict, index: dict) -> tuple[int, int]:
    """Every restored leaf of a checkpoint against what was saved: a
    compressed one equals the plain codec's round trip of the saved leaf
    (its format and block from the index), a raw one the saved bits.
    ``saved`` and ``got`` are ``checkpoint.flatten`` dicts. Returns the
    number of compressed leaves and of their per-layer parts (each part is
    quantized and restored on its own)."""
    import torch

    from repro_torch.core.f2p import F2PFormat, Flavor
    from repro_torch.kernels import f2p_quant as Q

    assert saved.keys() == got.keys() == index.keys()
    n_q = n_parts = 0
    for name, e in index.items():
        a_parts = list(saved[name]) if isinstance(saved[name], list) \
            else [saved[name]]
        b_parts = list(got[name]) if isinstance(got[name], list) \
            else [got[name]]
        for a, b in zip(a_parts, b_parts):
            if e["codec"] == "qtensor":
                fmt = F2PFormat(e["fmt"]["n_bits"], e["fmt"]["h_bits"],
                                Flavor(e["fmt"]["flavor"]),
                                e["fmt"]["signed"])
                w = a.detach().clone(memory_format=torch.contiguous_format)
                Q.ef_roundtrip_plain(w, None, fmt, e["block"], False)
                assert torch.equal(_bits(b), _bits(w)), \
                    f"restored {name} != plain 16-bit round trip"
            else:
                assert torch.equal(_bits(a.detach()), _bits(b.detach())), \
                    f"restored raw leaf {name} differs"
        if e["codec"] == "qtensor":
            n_q += 1
            n_parts += len(a_parts)
    return n_q, n_parts


def moe_scout_train(dev) -> dict:
    """13(a): llama4-scout at full width, 1 layer (its whole pattern) and
    MOE_TRAIN_EXPERTS of its 16 experts, through make_train_step with the
    train CLI's configs: MOE_TRAIN_STEPS steps of batch 8 x seq 128. One
    round-trip launch per step and no per-leaf B5 / B6 launch, step 0's
    compressed gradients and residuals equal to the plain round trip on g
    and r as autograd hands them over (post-accumulate-grad hooks; the 3-D
    expert leaves among them), finite losses (asserted). Prints ms per step
    and tokens/s over steps 2-5, the peak allocated beside the state's
    reckoning, step 1's device busy share and its split by kernel group,
    and each step's share of routed assignments that capacity dropped (from
    the MoE modules' load)."""
    import dataclasses
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import full_config
    from repro_torch.data import host_batch
    from repro_torch.kernels import cuda as C
    from repro_torch.launch.train import train_configs as cli_configs
    from repro_torch.models import moe as MOE
    from repro_torch.train import init_train_state, make_train_step

    full = full_config(MOE_ARCHS[0])
    cfg = dataclasses.replace(full, n_layers=len(full.pattern),
                              n_experts=MOE_TRAIN_EXPERTS)
    ocfg, ccfg, dcfg, _ = cli_configs(cfg, arch=MOE_ARCHS[0],
                                      steps=MOE_TRAIN_STEPS,
                                      global_batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    reck = train_state_bytes(cfg, ccfg)
    reck16 = train_state_bytes(dataclasses.replace(
        cfg, n_experts=full.n_experts), ccfg)
    log(f"moe_train: {cfg.name} cut to {cfg.n_layers} layer (its whole "
        f"pattern) and {cfg.n_experts} of {full.n_experts} experts: "
        f"{reck['params'] / 1e9:.2f}B parameters, train state "
        f"{reck['state'] / 1e9:.1f} GB + {reck['adamw_temporaries'] / 1e9:.1f}"
        f" GB of AdamW temporaries on the largest leaf (with "
        f"{full.n_experts} experts {reck16['state'] / 1e9:.1f} + "
        f"{reck16['adamw_temporaries'] / 1e9:.1f} GB) against the card's 80")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, ocfg, ccfg, seed=0, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    model, res = state["params"], state["residuals"]
    n_comp = sum(r is not None for r in res.values())
    T = TRAIN_BATCH * TRAIN_SEQ
    cap = MOE.capacity(T, cfg)
    log(f"moe_train: d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} "
        f"expert d_ff={cfg.d_ff} V={cfg.vocab_size} top-"
        f"{cfg.experts_per_token} + {cfg.n_shared_experts} shared, capacity "
        f"{cfg.capacity_factor} ({cap} slots of {T} tokens), {cfg.dtype}, "
        f"remat {cfg.remat}; state on the card in {init_s:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB; {n_comp} of "
        f"{len(res)} gradient leaves compressed ({ccfg.fmt.n_bits}-bit, "
        f"block {ccfg.block})")
    step0 = Step0RoundTrip(model, res, ccfg)
    tap = {}      # (module, step) -> its first call's load (remat recomputes)
    step_now = [0]

    def on_moe(mod, args, out):
        tap.setdefault((id(mod), step_now[0]), out[1]["load"].detach())

    moes = [m for m in model.modules() if isinstance(m, MOE.MoE)]
    taps = [m.register_forward_hook(on_moe) for m in moes]
    step_fn = make_train_step(cfg, ocfg, ccfg)
    losses, step_s, drops, prof_res, gnorms = [], [], [], None, []
    for step in range(MOE_TRAIN_STEPS):
        step_now[0] = step
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in host_batch(dcfg, step).items()}
        before = dict(C.LAUNCHES)
        ctx = profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) \
            if step == 1 else contextlib.nullcontext()
        with ctx as prof:
            t = time.perf_counter()
            state, m = step_fn(state, batch)
            loss = float(m["loss"])
            sync(dev)
            dt = time.perf_counter() - t
        if prof is not None:
            prof_res = device_profile(prof, dt * 1e6, ("ef_roundtrip_kernel",
                                                       "quantize_kernel"))
            del prof
            gc.collect()
        step_s.append(dt)
        losses.append(loss)
        gnorms.append(float(m["grad_norm"]))
        n = {k: C.LAUNCHES[k] - before[k] for k in ("ef_roundtrip",
                                                    "quantize", "dequantize")}
        loads = [tap[(id(mo), step)] for mo in moes]
        dropped = sum(float(MOE.dropped(cap, ld)) for ld in loads)
        routed = sum(float(ld.sum()) for ld in loads)
        drops.append(dropped / routed)
        assert math.isfinite(loss), f"scout step {step}: loss {loss}"
        assert n == {"ef_roundtrip": 1, "quantize": 0, "dequantize": 0}, \
            f"scout step {step}: launches {n} ({n_comp} leaves)"
        if step == 0:
            assert step0.check("scout step 0") == n_comp
            log(f"moe_train: step 0 compressed gradients and residuals == "
                f"plain round trip on g + r, bitwise, all {n_comp} leaves "
                f"(the [{cfg.n_experts}, {cfg.d_model}, {cfg.d_ff}] expert "
                "leaves among them)")
        log(f"moe_train: scout step {step} loss {loss:.4f} gnorm "
            f"{float(m['grad_norm']):.3f} {dt * 1e3:.1f} ms, round trip "
            f"{n['ef_roundtrip']} (B5 {n['quantize']} B6 {n['dequantize']}), "
            f"capacity dropped {int(dropped)} of {int(routed)} routed "
            f"assignments ({100 * drops[-1]:.2f}%)"
            + (" (profiled)" if step == 1 else ""))
    for h in taps:
        h.remove()
    peak = torch.cuda.max_memory_allocated()
    steady = step_s[2:]
    ms = 1e3 * sum(steady) / len(steady)
    tok_s = T / (ms / 1e3)
    log_profile("scout train step 1", prof_res)
    log(f"moe_train: steps 2-{MOE_TRAIN_STEPS - 1}: {ms:.1f} ms per step, "
        f"{tok_s:.0f} tokens/s; peak allocated {peak / 1e9:.2f} GB (state "
        f"reckoned {reck['state'] / 1e9:.1f} GB + "
        f"{reck['adamw_temporaries'] / 1e9:.1f} GB of AdamW temporaries); "
        f"device busy {100 * (prof_res['device_busy_share'] or 0):.1f}% of "
        f"step 1")
    out = dict(arch=cfg.name, layers=cfg.n_layers,
               experts=f"{cfg.n_experts} of {full.n_experts}",
               params=reck["params"], state_bytes=reck["state"],
               adamw_temporaries=reck["adamw_temporaries"],
               state_bytes_16_experts=reck16["state"], batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, capacity=cap, init_s=init_s, losses=losses,
               grad_norms=gnorms,
               step_ms=[1e3 * x for x in step_s], ms_per_step=ms,
               tokens_per_s=tok_s, peak_alloc_bytes=peak,
               compressed_leaves=n_comp, drop_share=drops,
               busy_share=prof_res["device_busy_share"],
               groups_ms=prof_res["groups_ms"], profile=prof_res)
    del state, model, res, step_fn, moes, tap
    return out


def moe_smoke_train(dev, arch) -> dict:
    """13(b): smoke ``arch`` (f32) trained MOE_SMOKE_STEPS steps with the
    train CLI's configs on the card and on the CPU from the same weights
    (seed 0, made on the CPU): losses within 1e-3 relative, one round-trip
    launch per card step (asserted); after step 2 the card's state is saved
    with the CLI checkpointer's settings (F2P16 through B5's codes mode, the
    arch's policy) but leaves of MOE_SMOKE_CKPT_MIN_SIZE elements up, and
    restored into a fresh state (through B6), each leaf bitwise against
    the plain codec's round trip or the saved bits; then step 3 runs on."""
    import json as _json
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.data import host_batch
    from repro_torch.kernels import cuda as C
    from repro_torch.launch.train import train_configs as cli_configs
    from repro_torch.models import init_params
    from repro_torch.train import checkpoint, init_train_state, make_train_step

    cfg = smoke_config(arch)
    ocfg, ccfg, dcfg, policy = cli_configs(
        cfg, arch=arch, steps=MOE_SMOKE_STEPS, global_batch=TRAIN_BATCH,
        seq=TRAIN_SEQ)
    weights = init_params(cfg, seed=0, device="cpu").state_dict()
    devs = {"host": "cpu", "card": dev}
    states = {}
    for w, d in devs.items():
        states[w] = init_train_state(cfg, ocfg, ccfg, seed=0, device=d)
        states[w]["params"].load_state_dict(weights)
    step_fn = make_train_step(cfg, ocfg, ccfg)
    losses = {"host": [], "card": []}
    ck = tempfile.mkdtemp(prefix="chip_smoke_moe_ckpt_")
    try:
        for step in range(MOE_SMOKE_STEPS):
            batch = host_batch(dcfg, step)
            for w, d in devs.items():
                before = C.LAUNCHES["ef_roundtrip"]
                states[w], m = step_fn(states[w], {
                    k: torch.from_numpy(v).to(d) for k, v in batch.items()})
                losses[w].append(float(m["loss"]))
                if w == "card":
                    nrt = C.LAUNCHES["ef_roundtrip"] - before
                    assert nrt == 1, f"{arch} step {step}: {nrt} round trips"
            if step == 1:      # the state of step 2: saved and restored
                q0, d0 = C.LAUNCHES["quantize"], C.LAUNCHES["dequantize"]
                checkpoint.save(ck, 2, states["card"], compress=True,
                                policy=policy,
                                min_size=MOE_SMOKE_CKPT_MIN_SIZE)
                save_q = C.LAUNCHES["quantize"] - q0
                with open(os.path.join(ck, "step_2", "index.json")) as f:
                    index = _json.load(f)["leaves"]
                fresh = init_train_state(cfg, ocfg, ccfg, seed=1, device=dev)
                checkpoint.restore(ck, fresh)
                sync(dev)
                restore_d = C.LAUNCHES["dequantize"] - d0
                assert int(fresh["opt"]["step"]) == 2
                n_q, n_parts = check_restored(
                    checkpoint.flatten(states["card"]),
                    checkpoint.flatten(fresh), index)
                assert save_q == restore_d == n_parts > 0, \
                    (f"{arch}: {save_q} B5 codes launches at save, "
                     f"{restore_d} B6 at restore, {n_q} F2P16 leaves in "
                     f"{n_parts} parts")
                del fresh
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    got, want = losses["card"], losses["host"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    assert all(math.isfinite(x) for x in got) and rel <= MOE_SMOKE_LOSS_TOL, \
        f"{arch}: card losses {got} vs CPU {want}"
    # every leaf after the last step, and its move off the shared start
    # (the three steps' updates: a wrong gradient shows there even where
    # the losses hardly move), card against CPU, relative in norm
    host = dict(states["host"]["params"].named_parameters())
    leaf_rel, move_rel = {}, {}
    for name, p in states["card"]["params"].named_parameters():
        c, h = p.detach().float().cpu(), host[name].detach().float()
        w0 = weights[name].float()
        leaf_rel[name] = rel_norm(c, h)
        move_rel[name] = rel_norm(c - w0, h - w0)
    worst_leaf = max(leaf_rel, key=leaf_rel.get)
    worst_move = max(move_rel, key=move_rel.get)
    assert leaf_rel[worst_leaf] <= MOE_SMOKE_LEAF_TOL and \
        move_rel[worst_move] <= MOE_SMOKE_MOVE_TOL, \
        (f"{arch}: leaf {worst_leaf} {leaf_rel[worst_leaf]:.2e}, move "
         f"{worst_move} {move_rel[worst_move]:.2e}")
    log(f"moe_train: smoke {cfg.name} {MOE_SMOKE_STEPS} steps card vs CPU "
        f"losses {[round(x, 6) for x in got]} / "
        f"{[round(x, 6) for x in want]} (max rel {rel:.2e} <= "
        f"{MOE_SMOKE_LOSS_TOL:g}); {len(leaf_rel)} leaves after step "
        f"{MOE_SMOKE_STEPS}: max rel in norm {leaf_rel[worst_leaf]:.2e} "
        f"({worst_leaf}) <= {MOE_SMOKE_LEAF_TOL:g}, their moves "
        f"{move_rel[worst_move]:.2e} ({worst_move}) <= "
        f"{MOE_SMOKE_MOVE_TOL:g}; one "
        f"round trip per step; checkpoint at step 2: {n_q} F2P16 leaves "
        f"in {n_parts} layer parts ({save_q} B5 codes launches at save, "
        f"{restore_d} B6 at restore) "
        f"== plain round trip, {len(index) - n_q} raw, bitwise")
    del states
    return dict(losses=got, cpu_losses=want, max_rel=rel,
                leaf_max_rel=leaf_rel[worst_leaf], leaf_worst=worst_leaf,
                move_max_rel=move_rel[worst_move], move_worst=worst_move,
                f2p16_leaves=n_q,
                raw_leaves=len(index) - n_q, save_launches=save_q,
                restore_launches=restore_d)


def rel_norm(a, b) -> float:
    """|a - b| / |b| in the 2-norm; 0 where both are 0."""
    nb, nd = float(b.norm()), float((a - b).norm())
    return nd / nb if nb else (0.0 if nd == 0 else math.inf)


def chunked_train_check(dev) -> dict:
    """13(c): the train forward's ``attn_impl="chunked"`` on the card.
    Smoke llama3.2-3b (f32, dense: no routing to flip on a rounding) with a
    chunk of MOE_CHUNK over the CLI's 8 x 128 batch: loss and every
    gradient leaf, chunked on the card against naive on the card and
    against chunked on the CPU (same weights, seed 0), relative in norm.
    Launches no F2P kernel."""
    import dataclasses

    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig, host_batch
    from repro_torch.models import init_params
    from repro_torch.train import loss_and_grads

    base = smoke_config(ARCH)
    batch = host_batch(DataConfig(vocab_size=base.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH), 0)
    weights = init_params(base, seed=0, device="cpu").state_dict()
    runs = {}
    for tag, impl, d in (("card_chunked", "chunked", dev),
                         ("card_naive", "naive", dev),
                         ("cpu_chunked", "chunked", "cpu")):
        cfg = dataclasses.replace(base, attn_impl=impl, attn_chunk=MOE_CHUNK)
        model = init_params(cfg, seed=0, device=d)
        model.load_state_dict(weights)
        model.requires_grad_(True)
        loss, _, g = loss_and_grads(model, {
            k: torch.from_numpy(v).to(d) for k, v in batch.items()}, cfg)
        runs[tag] = (float(loss), {n: t.detach().float().cpu()
                                   for n, t in g.items()})
        del model, g
    out = {}
    for other in ("card_naive", "cpu_chunked"):
        (lc, gc_), (lo, go) = runs["card_chunked"], runs[other]
        lrel = abs(lc - lo) / abs(lo)
        grel = {n: rel_norm(gc_[n], go[n]) for n in gc_}
        worst = max(grel, key=grel.get)
        assert math.isfinite(lc) and lrel <= MOE_CHUNK_LOSS_TOL and \
            grel[worst] <= MOE_CHUNK_GRAD_TOL, \
            (f"chunked on the card vs {other}: loss {lc} / {lo}, "
             f"{worst} {grel[worst]:.2e}")
        out[other] = dict(loss_rel=lrel, grad_max_rel=grel[worst],
                          grad_worst=worst)
    log(f"moe_train: chunked attention (chunk {MOE_CHUNK} over "
        f"{TRAIN_SEQ}) in smoke {base.name}'s train forward on the card: "
        f"loss {runs['card_chunked'][0]:.6f}; against naive on the card "
        f"loss rel {out['card_naive']['loss_rel']:.2e}, gradients "
        f"{out['card_naive']['grad_max_rel']:.2e}; against chunked on the "
        f"CPU loss rel {out['cpu_chunked']['loss_rel']:.2e}, gradients "
        f"{out['cpu_chunked']['grad_max_rel']:.2e} (limits "
        f"{MOE_CHUNK_LOSS_TOL:g} / {MOE_CHUNK_GRAD_TOL:g} in norm)")
    return dict(arch=base.name, chunk=MOE_CHUNK, seq=TRAIN_SEQ,
                loss=runs["card_chunked"][0], **out)


def moe_train_phase(dev) -> dict:
    """Phase 13: the launch counters are zeroed, then (a) full-width scout
    trains, (b) the three MoE smoke configs train card against CPU with
    a checkpoint round trip each and (c) the chunked train forward runs
    on the card; the counters are read after (c)."""
    import gc

    import torch

    from repro_torch.kernels import cuda as C

    t0 = time.perf_counter()
    C.reset_launches()
    res = dict(scout=moe_scout_train(dev))
    gc.collect()
    torch.cuda.empty_cache()
    res["smoke"] = {a: moe_smoke_train(dev, a) for a in MOE_ARCHS}
    res["chunked"] = chunked_train_check(dev)
    sync(dev)
    counts = dict(C.LAUNCHES)
    res["launches"] = {k: counts[k] for k in ("ef_roundtrip", "quantize",
                                              "dequantize")}
    want_rt = MOE_TRAIN_STEPS + MOE_SMOKE_STEPS * len(MOE_ARCHS)
    assert res["launches"]["ef_roundtrip"] == want_rt, res["launches"]
    assert res["launches"]["quantize"] > 0 and \
        res["launches"]["dequantize"] > 0, res["launches"]
    res["seconds"] = time.perf_counter() - t0
    log(f"moe_train: phase 13 in {res['seconds']:.1f} s; main-path launches "
        f"{res['launches']}")
    return res


def moe_train_summary(mt: dict) -> dict:
    sc = mt["scout"]
    return dict(
        scout={k: sc[k] for k in (
            "arch", "layers", "experts", "params", "state_bytes",
            "adamw_temporaries", "batch", "seq", "losses", "ms_per_step",
            "tokens_per_s", "peak_alloc_bytes", "compressed_leaves",
            "drop_share", "busy_share", "groups_ms")},
        smoke={a: {k: r[k] for k in ("losses", "max_rel", "leaf_max_rel",
                                     "move_max_rel", "f2p16_leaves",
                                     "save_launches", "restore_launches")}
               for a, r in mt["smoke"].items()},
        chunked=mt["chunked"],
        launches=mt["launches"], seconds=mt["seconds"])


# ---------------------------------------------------------------------------
# phase 14: the example twins
# ---------------------------------------------------------------------------
def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` is not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# what phase 14 keeps of a twin's report: numbers (the losses' first and
# last printed value) and whole summary lines
REPORT_NUMBERS = {
    "loss": r"step +\d+ loss ([\d.]+)",
    "agreement_pct": r"token agreement exact-vs-F2P8: ([\d.]+)%",
    "tok_s": r"(\d+) tok/s",
    "m_arrivals_s": r"\(([\d.]+)M arrivals/s\)",
    "mean_rel_pct": r"mean rel err: ([\d.]+)%"}
REPORT_LINES = {
    "sequential": r"12 requests bit-for-bit identical to (.*)",
    "pool": r"KV pool +: (.*)",
    "wire": r"wire bytes/round: (.*)",
    "packed": r"packed mixed policy: (.*)",
    "final_loss": r"final eval loss: (.*)",
    "faulted": r"faulted run: (.*)",
    "policy": r"  policy vs best single (\(.*)",
    "overall": r"overall: (.*)"}


def _report_numbers(out: str) -> dict:
    import re

    res = {}
    for name, pat in REPORT_NUMBERS.items():
        vals = [float(x) for x in re.findall(pat, out)]
        if vals:
            res[name] = [vals[0], vals[-1]] if name == "loss" else vals
    for name, pat in REPORT_LINES.items():
        m = re.search(pat, out)
        if m:
            res[name] = m.group(1).strip()
    return res


# phase 14(a): the shapes the twins give their kernels that no earlier
# phase checks. serve_f2p_kv: its demo LM (f32) through the unfused Engine
# over a dense [4, 48] cache, a 32-token prefill then decode at 32..47.
# serve_continuous: smoke llama3.2-3b (f32) in 4 slots of 64 positions over
# 8-token pages, prompts of 4..24 tokens and at most 24 new (kv_len <= 48),
# and its batch-1 sequential replay. The sketch: its 4 x 4096 12-bit LI^2
# cells and 2^16-packet batches. The quickstart: model_100m's f32 leaves.
EX_SERVE_B, EX_SERVE_PROMPT, EX_SERVE_SEQ = 4, 32, 48
EX_CONT_SLOTS, EX_CONT_SEQ, EX_CONT_KV = 4, 64, (4, 48)
EX_SKETCH = dict(depth=4, width=4096, n_bits=12, h_bits=2, flavor="li")
EX_SKETCH_PACKETS, EX_SKETCH_FLOWS, EX_SKETCH_BATCH = 1 << 20, 1 << 20, 1 << 16


def example_counter_at(dev) -> dict:
    """B9 and B10 bitwise against their plain versions at the sketch
    twin's cells (:data:`EX_SKETCH`) over the budget of its trace's first
    batch; B9 timed there beside its bound."""
    import torch

    from repro_torch.core.f2p import F2PFormat, Flavor
    from repro_torch.kernels import cost
    from repro_torch.kernels import f2p_counter as FC

    trace = load_example("torch_sketch_zipf_trace").make_trace(
        EX_SKETCH_PACKETS, EX_SKETCH_FLOWS)
    budget = torch.from_numpy(first_batch_budget(
        trace, EX_SKETCH["width"], EX_SKETCH_BATCH, EX_SKETCH)).to(dev)
    fmt = (EX_SKETCH["flavor"], EX_SKETCH["n_bits"])
    adv_err, est_err = counter_bitwise(dev, budget, (fmt,))
    grid = F2PFormat(n_bits=fmt[1], h_bits=EX_SKETCH["h_bits"],
                     flavor=Flavor(fmt[0])).payload_grid
    luts = [torch.from_numpy(t).to(dev) for t in FC.advance_tables(grid)]
    st = torch.zeros(tuple(budget.shape), dtype=torch.int32, device=dev)
    u = FC.hash_uniforms(7, 0, FC.PALLAS_SWEEPS, tuple(budget.shape),
                         device=dev)
    live = live_sweeps(st, budget, luts, u)
    r = dict(ms=cuda_ms(lambda: FC.counter_advance(st, budget, *luts, 7),
                        iters=100),
             bound_ms=max(bound_ms(cost.nbytes(
                 "counter_advance", st, budget, *luts, 7)),
                 live * ADVANCE_OPS_PER_SWEEP
                          / F32_OPS_PER_S * 1e3),
             max_abs_err=adv_err, estimate_max_abs_err=est_err,
             live_sweeps=live,
             shape=f"state/budget {list(budget.shape)}, {fmt[1]}-bit "
                   f"{fmt[0].upper()}^2, first {EX_SKETCH_BATCH}-packet "
                   f"batch's budget")
    log(f"examples : B9 {r['shape']}: == plain bitwise (zero and random "
        f"state, sweep0 0 and 32), B10 too; advance {r['ms']:.5f} ms "
        f"(bound {r['bound_ms']:.5f}, {live} live cell-sweeps)")
    return r


def example_train_codec_at(dev) -> dict:
    """The quickstart's B5 / B6 work at model_100m's own leaves (its
    seed-0 parameters): the round trip over every compressed f32 gradient
    leaf in one launch (error feedback on, g randn x 1e-3, r randn x 1e-5)
    bitwise against ef_roundtrip_plain per leaf; the checkpoint's F2P16
    codes (B5, block min(128, last dim)) and their f32 decode (B6) bitwise
    against quantize_plain / dequantize_plain on every leaf shape the
    checkpoint compresses."""
    import torch

    from repro_torch.kernels import f2p_quant as Q
    from repro_torch.models import init_params
    from repro_torch.models.convert import reference_numel
    from repro_torch.optim import CompressionConfig
    from repro_torch.optim.adamw import named_params
    from repro_torch.optim.compress import init_residuals
    from repro_torch.train.checkpoint import CKPT_FMT

    cfg = load_example("torch_quickstart").model_100m()
    params = init_params(cfg, seed=0, device=dev)
    named = named_params(params)
    ccfg = CompressionConfig()
    res = init_residuals(params, ccfg, len(cfg.pattern))
    names = [n for n, r in res.items() if r is not None]
    g = torch.Generator(device=dev).manual_seed(28)
    gs = [torch.randn(named[n].shape, generator=g, device=dev) * 1e-3
          for n in names]
    rs = [torch.randn(named[n].shape, generator=g, device=dev) * 1e-5
          for n in names]
    pg, pr = [x.clone() for x in gs], [x.clone() for x in rs]
    Q.f2p_ef_roundtrip(gs, rs, ccfg.fmt, block=ccfg.block, error_feedback=True)
    for n, a, b, c, d in zip(names, gs, rs, pg, pr):
        Q.ef_roundtrip_plain(c, d, ccfg.fmt, ccfg.block, True)
        assert _same_bits(a, c), f"quickstart round trip: gradient {n}"
        assert _same_bits(b, d), f"quickstart round trip: residual {n}"
    n_el = sum(x.numel() for x in gs)
    del gs, rs, pg, pr
    sizes = reference_numel(named, len(cfg.pattern))
    shapes = {}
    for n, x in named.items():
        if sizes[n] >= 65536:
            shapes.setdefault(tuple(x.shape), x)
    for shape, x in shapes.items():
        blk = min(128, shape[-1])
        x2 = x.reshape(-1, shape[-1])
        c, s = Q.f2p_quantize_codes(x2, CKPT_FMT, block=blk)
        pc, ps = Q.quantize_plain(x2, CKPT_FMT, blk)
        assert torch.equal(_bits(c), _bits(pc)) and torch.equal(s, ps), \
            f"quickstart checkpoint codes differ at {shape}"
        d = Q.f2p_dequantize_codes(c, s, CKPT_FMT, block=blk,
                                   out_dtype=torch.float32)
        assert torch.equal(_bits(d), _bits(Q.dequantize_plain(
            c, s, CKPT_FMT, blk, torch.float32))), \
            f"quickstart checkpoint decode differs at {shape}"
    del params, named, res
    torch.cuda.empty_cache()
    r = dict(roundtrip_leaves=len(names), roundtrip_elements=n_el,
             checkpoint_shapes=[list(k) for k in shapes], max_abs_err=0.0)
    log(f"examples : quickstart B5 round trip == plain over its "
        f"{len(names)} compressed f32 leaves ({n_el} elements, one launch); "
        f"F2P16 checkpoint codes (B5) and their decode (B6) == plain at "
        f"{r['checkpoint_shapes']}")
    return r


def example_kernel_checks(dev) -> dict:
    """Phase 14(a): each kernel the twins launch, at the shapes they give
    it where no earlier phase checks them, against its plain version on
    the same inputs: B3 and B4's K+V read at serve_f2p_kv's cache; B1/B2
    and B3 at serve_continuous's; B9/B10 at the sketch's cells; B5's round
    trip and codes and B6 at the quickstart's leaves. fed_avg and
    autotune_study run the codec at toy_task()'s leaves, which phase 9
    holds (B3-B6 bitwise at the 9 FL leaf shapes)."""
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.core.formats import named_format

    t = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(27)
    name = "f2p_sr_2_8s"
    fmt = named_format(name)
    out = {}

    demo = load_example("torch_serve_f2p_kv").demo_config()
    K, hd = demo.n_kv_heads, demo.head_dim
    for S, start in ((EX_SERVE_PROMPT, 0), (1, EX_SERVE_PROMPT),
                     (1, EX_SERVE_SEQ - 1)):
        kv_write_bitwise(dev, g, fmt, False, B=EX_SERVE_B, S=S, dtype="f32",
                         start=start, K=K, hd=hd, max_seq=EX_SERVE_SEQ)
    log(f"examples : serve_f2p_kv B3 == plain bitwise: f32 K and V "
        f"[{EX_SERVE_B}, S, {K}, {hd}] into a dense [{EX_SERVE_B}, "
        f"{EX_SERVE_SEQ}] {name} cache, S = {EX_SERVE_PROMPT} at 0 and S = "
        f"1 at {EX_SERVE_PROMPT} and {EX_SERVE_SEQ - 1}")
    out["serve_f2p_kv_kv_read"] = kv_read_at(
        dev, K, hd, name, EX_SERVE_B, EX_SERVE_SEQ, tag="examples")

    sm = smoke_config("llama3_2_3b")
    K, G, hd = sm.n_kv_heads, sm.n_heads // sm.n_kv_heads, sm.head_dim
    out["serve_continuous_attention"] = attention_at(
        dev, K, G, hd, name, B=EX_CONT_SLOTS, S=EX_CONT_SEQ, kv=EX_CONT_KV,
        tag="examples")
    for paged, B in ((True, EX_CONT_SLOTS), (False, EX_CONT_SLOTS),
                     (False, 1)):
        for S in (1, 24, 32):
            kv_write_bitwise(dev, g, fmt, paged, B=B, S=S, dtype="f32", K=K,
                             hd=hd, max_seq=EX_CONT_SEQ)
    kv_write_bitwise(dev, g, fmt, True, B=EX_CONT_SLOTS, dtype="f32", K=K,
                     hd=hd, max_seq=EX_CONT_SEQ, collide=True)
    log(f"examples : serve_continuous B3 == plain bitwise: f32 K and V [B, "
        f"S, {K}, {hd}], S in (1, 24, 32), paged (B = {EX_CONT_SLOTS}, 8-token "
        f"pages) and dense (B = {EX_CONT_SLOTS} and 1) over {EX_CONT_SEQ} "
        f"positions, and all slots on one dump position")
    out["sketch_counter_advance"] = example_counter_at(dev)
    out["quickstart_codec"] = example_train_codec_at(dev)
    out["seconds"] = time.perf_counter() - t
    return out


def examples_phase(dev) -> dict:
    """Phase 14: (a) the twins' kernels at their shapes against their plain
    versions (:func:`example_kernel_checks`); (b) each twin of examples/
    through ``main(argv)`` at its reference's defaults on the card, stdout
    captured (and written to chiprun_out/chip_smoke_examples/<run>.txt);
    rc 0 and the reference's acceptance line(s) asserted per run. The launch counts are zeroed just
    before each run and read just after it; over the phase B1-B6 and B9
    must have launched. No example reaches B7/B8 or B10
    (``EXAMPLES_UNREACHED``); their counts are reported as they are."""
    import gc
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.kernels import cuda as C

    out_dir = ROOT / "chiprun_out" / "chip_smoke_examples"
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_examples_"))
    t_phase = time.perf_counter()
    checks = example_kernel_checks(dev)
    runs, total = {}, {k: 0 for k in C.LAUNCHES}
    try:
        for tag, name, argv, accept in EXAMPLE_RUNS:
            argv = list(argv)
            if name == "torch_quickstart":
                argv += ["--ckpt-dir", str(tmp / "quickstart_ckpt")]
            if argv[:1] == ["--trace"]:
                argv.insert(1, str(tmp / "serve.trace.json"))
            argv += ["--device", dev]
            mod = load_example(name)
            buf = io.StringIO()
            sync(dev)
            C.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = mod.main(argv)
            sync(dev)
            seconds = time.perf_counter() - t0
            launches = {k: v for k, v in C.LAUNCHES.items() if v}
            for k, v in C.LAUNCHES.items():
                total[k] += v
            out = buf.getvalue()
            (out_dir / f"{tag}.txt").write_text(out)
            missing = [a for a in accept if a not in out]
            runs[tag] = dict(example=f"examples/{name}.py", argv=argv, rc=rc,
                             seconds=seconds, launches=launches,
                             report=_report_numbers(out))
            tail = [ln for ln in out.splitlines() if ln.strip()][-3:]
            log(f"example  : {tag:18s} rc {rc} in {seconds:.1f} s; "
                f"launches {launches}")
            for ln in tail:
                log(f"  {tag:16s}| {ln}")
            assert rc == 0, f"{tag}: exit status {rc}"
            assert not missing, f"{tag}: report lacks {missing}"
            if tag == "quickstart_resume":
                assert launches.get("dequantize", 0) > 0, \
                    "the quickstart's resume never launched B6"
            del mod
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {
        "attention_paged": total["attention_paged"],
        "attention_packed": total["attention_packed"],
        "quantize_packed": total["kv_write"] + total["quantize_packed"],
        "dequantize_packed": total["kv_read"] + total["dequantize_packed"],
        "quantize": total["quantize"],
        "ef_roundtrip": total["ef_roundtrip"],
        "dequantize": total["dequantize"],
        "counter_advance": total["counter_advance"],
        "counter_estimate": total["counter_estimate"],
        "dequant_matmul": total["dequant_matmul"],
        "dequant_matmul_packed": total["dequant_matmul_packed"]}
    for name, n in launches.items():
        if name not in EXAMPLES_UNREACHED:
            assert n > 0, f"phase 14 never launched {name}"
    res = dict(checks=checks, runs=runs, launches=launches,
               numpy=np.__version__, seconds=time.perf_counter() - t_phase)
    log(f"examples : phase 14 in {res['seconds']:.1f} s (numpy "
        f"{np.__version__}); launches {launches}; no example reaches "
        f"{EXAMPLES_UNREACHED}")
    return res


def examples_summary(ex: dict) -> dict:
    def brief(v):
        if not isinstance(v, dict):
            return v
        if "max_abs_err" in v:
            return {n: v[n] for n in ("ms", "bound_ms", "max_abs_err")
                    if n in v}
        return {k: brief(x) for k, x in v.items()}

    return dict(runs={t: {k: r[k] for k in ("seconds", "rc", "launches",
                                            "report")}
                      for t, r in ex["runs"].items()},
                checks=brief(ex["checks"]),
                launches=ex["launches"], numpy=ex["numpy"],
                seconds=ex["seconds"])


# ---------------------------------------------------------------------------
# phase 15: the sharded part (A12). One card: ranks share it as processes
# over gloo (NCCL refuses two ranks on one device); a world of one runs the
# mesh path over NCCL.
# ---------------------------------------------------------------------------
def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank, world, port, fn, args, out_dir, dev):
    """A spawned rank: its device, a gloo group, ``fn``, its result."""
    import pickle

    import torch
    import torch.distributed as dist

    if torch.device(dev).type == "cuda":
        torch.cuda.set_device(torch.device(dev).index or 0)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        res = fn(rank, world, dev, *args)
    finally:
        dist.destroy_process_group()
    with open(Path(out_dir) / f"{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def spawn_ranks(fn, world: int, dev, *args) -> list:
    """``fn(rank, world, dev, *args)`` on ``world`` spawned gloo ranks that
    share ``dev``; their results in rank order."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank_entry, args=(world, _free_port(), fn, args,
                                              d, dev),
                           nprocs=world, start_method="spawn")
        out = []
        for r in range(world):
            with open(Path(d) / f"{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


def _launch_deltas(before: dict, names) -> dict:
    from repro_torch.kernels import cuda as C

    return {k: C.LAUNCHES[k] - before[k] for k in names}


PSUM_KERNELS = ("quantize", "dequantize", "quantize_packed",
                "dequantize_packed")


def psum_rank(rank, world, dev, leaves, seed=100):
    """15(a) on one rank: ``compressed_psum`` of each leaf (the rank's
    gradient drawn from ``seed + rank``), unpacked and packed. This rank's
    B5 / B6 (B3 / B4) launches are held on its shard against the plain
    versions on the card: every rank draws every rank's gradient, so it
    knows the exact sum shard (two f32 addends: any order gives its
    bits)."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.kernels import cuda as C
    from repro_torch.kernels import f2p_quant as Q
    from repro_torch.launch import mesh as M
    from repro_torch.optim.compress import CompressionConfig, compressed_psum

    C.reset_launches()
    out = {}
    for tag, shape in leaves:
        gs = [torch.randn(shape, generator=torch.Generator(dev).manual_seed(
            seed + r), device=dev) * 1e-3 for r in range(world)]
        g, total = gs[rank], sum(gs[1:], gs[0])
        rows = shape[0] // world
        res = {}
        for packed in (False, True):
            ccfg = CompressionConfig(packed=packed)
            fmt, block = ccfg.fmt, ccfg.block
            before = dict(C.LAUNCHES)
            got = compressed_psum(g, None, ccfg)
            sync(dev)
            n = _launch_deltas(before, PSUM_KERNELS)
            # the plain composition of every rank's shard on the card
            quant = Q.quantize_packed_plain if packed else Q.quantize_plain
            deq = (Q.dequantize_packed_plain if packed
                   else Q.dequantize_plain)
            parts = [quant(total[r * rows:(r + 1) * rows], fmt, block)
                     for r in range(world)]
            codes = torch.cat([c for c, _ in parts])
            scales = torch.cat([sc * torch.tensor(1.0 / world).to(dev)
                                for _, sc in parts])
            want = deq(codes, scales, fmt, block)
            mine = total[rank * rows:(rank + 1) * rows]
            kq = (Q.f2p_quantize_packed if packed else Q.f2p_quantize_codes)(
                mine, fmt, block=block)
            kd = (Q.f2p_dequantize_packed if packed
                  else Q.f2p_dequantize_codes)(codes, scales, fmt,
                                               block=block)
            assert torch.equal(kq[0], parts[rank][0]) and torch.equal(
                kq[1], parts[rank][1]), \
                f"15(a) {tag} packed={packed} rank {rank}: shard quantize " \
                "!= plain"
            assert torch.equal(_bits(kd), _bits(want)), \
                f"15(a) {tag} packed={packed}: dequantize != plain"
            assert torch.equal(_bits(got), _bits(want)), \
                f"15(a) {tag} packed={packed} rank {rank}: compressed_psum " \
                "!= the plain composition"
            # within the codec's error of the f32 mean: half the largest
            # grid gap of each block's scale
            mean = total * (1.0 / world)
            bm = mean.abs().reshape(shape[0], -1, block).amax(-1)
            bound = (bm / fmt.max_value * float(np.max(np.diff(fmt.grid)))
                     / 2).repeat_interleave(block, dim=-1).reshape(shape)
            err = float(((got - mean).abs() - bound).max())
            assert err <= 1e-12, f"15(a) {tag}: error past the codec bound"
            ts = []
            for _ in range(3):
                sync(dev)
                t = time.perf_counter()
                compressed_psum(g, None, ccfg)
                sync(dev)
                ts.append(1e3 * (time.perf_counter() - t))
            res[packed] = dict(launches=n, ms=statistics.median(ts),
                               max_abs_err=float((got - mean).abs().max()),
                               got=got)
        got_p, got_u = res[True].pop("got"), res[False].pop("got")
        assert torch.equal(_bits(got_p), _bits(got_u)), \
            f"15(a) {tag}: packed != unpacked"
        out[tag] = res
    out["host_staged"] = sorted(M.HOST_STAGED)
    return out


def sketch_rank(rank, world, dev, sketch_kw, n_packets, n_flows, batch):
    """15(d) on one rank: the row-sharded sketch fed the trace in batches
    of device keys, flushed, estimates() read; B9 with this shard's lane
    base held against the plain version on the card. Returns the whole
    state (gathered) and this rank's B9 / B10 launches."""
    import torch

    from repro_torch.kernels import cuda as C
    from repro_torch.kernels import f2p_counter as FC
    from repro_torch.launch.mesh import make_sketch_mesh
    from repro_torch.sketch import F2PSketch, SketchConfig

    trace = torch.from_numpy(make_trace(n_packets, n_flows, seed=0))
    sk = F2PSketch(SketchConfig(**sketch_kw), device=dev,
                   mesh=make_sketch_mesh(world, device=dev))
    C.reset_launches()
    sync(dev)
    t = time.perf_counter()
    for pos in range(0, trace.numel(), batch):
        sk.update(trace[pos:pos + batch].to(dev))
    sk.flush()
    est = sk.estimates()
    sync(dev)
    seconds = time.perf_counter() - t
    launches = {k: C.LAUNCHES[k] for k in ("counter_advance",
                                           "counter_estimate")}
    # B9 on this shard, with its lane base, against the plain version
    budget = (torch.arange(sk.state.numel(), device=dev) % 97).to(
        torch.float32).reshape(sk.state.shape)
    lb = sk._row0 * sketch_kw["width"]
    luts = (sk._p_lut, sk._run_lut, sk._logq_lut)
    got = FC.counter_advance(sk.state, budget, *luts, 12345, lane_base=lb)
    u = FC.hash_uniforms(12345, 0, FC.PALLAS_SWEEPS, tuple(sk.state.shape),
                         device=dev, lane_base=lb)
    want = FC.counter_advance_plain(sk.state, budget, *luts, u)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
        f"15(d) rank {rank}: B9 with lane base {lb} != plain"
    return dict(state=sk._gather_rows(sk.state).cpu().numpy(),
                estimates=est, rows=tuple(sk.state.shape), lane_base=lb,
                launches=launches, seconds=seconds, fill=sk.fill(),
                arrivals=sk.arrivals)


def shard_cli(args: list, env: dict, timeout: int = 600):
    """``python -m repro_torch.launch.train`` with ``args``: (rc, stdout,
    seconds)."""
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *args], capture_output=True, text=True, env=env,
                       cwd=str(ROOT), timeout=timeout)
    if r.returncode not in (0, 42):
        log(r.stdout[-3000:])
        log(r.stderr[-6000:])
    return r.returncode, r.stdout, time.perf_counter() - t


def _cli_losses(out: str) -> dict:
    import re

    return {int(m[1]): float(m[2])
            for m in re.finditer(r"step\s+(\d+) loss ([-\d.]+)", out)}


def shard_train_cli(dev, full: bool = True, plain_losses=None) -> dict:
    """15(b): the reference launcher's own example, ``--arch xlstm_125m
    --full --mesh-shape 2,2`` (4 ranks on the card, the model axis split),
    a checkpoint every step and killed by ``--die-at-step``: its losses
    before the kill against a ``1,1`` run's, or against ``plain_losses``
    (phase 11(d)'s: the same arch, configs and data in one process) when
    given; then restarted on ``2,1`` from the latest committed step (the
    state split over the model axis restored onto a mesh without one)."""
    import os
    import shutil
    import tempfile

    from repro_torch.train import checkpoint

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = ["--arch", "xlstm_125m", "--steps", str(SHARD_XLSTM_STEPS),
            "--log-every", "1"] + (["--full"] if full else [])
    once = ["--ckpt-every", "100"]   # the final save only
    if not full:   # the CPU rehearsal: a short sequence
        base += ["--seq", "16", "--global-batch", "4"]
    if "cuda" not in str(dev):
        base += ["--device", "cpu"]
    work = Path(tempfile.mkdtemp(prefix="shard_cli_"))
    try:
        d = str(work / "elastic")
        rc, out, sec = shard_cli(base + [
            "--mesh-shape", "2,2", "--ckpt-dir", d, "--ckpt-every", "1",
            "--die-at-step", str(SHARD_DIE_AT)], env)
        assert rc == 42 and f"SIMULATED PREEMPTION at step {SHARD_DIE_AT}" \
            in out, f"15(b) --die-at-step: rc {rc}"
        lines = out.splitlines()
        a = _cli_losses(out)
        assert sorted(a) == list(range(SHARD_DIE_AT)), a
        if plain_losses:
            b, sec1 = {k: float(plain_losses[k]) for k in a}, 0.0
        else:
            e = env
            if not full:   # the CLI's 1,1 needs a card: the CPU
                # rehearsal joins a world of one instead
                e = dict(env, RANK="0", WORLD_SIZE="1",
                         MASTER_ADDR="localhost",
                         MASTER_PORT=str(_free_port()))
            rc1, out1, sec1 = shard_cli(base + once + [
                "--mesh-shape", "1,1", "--ckpt-dir", str(work / "1,1")], e)
            assert rc1 == 0 and out1.rstrip().endswith("done."), \
                f"15(b) --mesh-shape 1,1: rc {rc1}"
            b = _cli_losses(out1)
        first = lines[0]
        assert first.startswith("backend gloo  ranks 0:"), first
        ranks = next(x for x in lines if x.startswith("ranks "))
        assert set(a) <= set(b), (a, b)
        rel0 = abs(a[0] - b[0]) / abs(b[0])
        rel = max(abs(a[k] - b[k]) / abs(b[k]) for k in a)
        assert rel0 <= SHARD_LOSS0_RTOL, f"15(b) step 0 losses: {rel0}"
        assert rel <= SHARD_LOSS_RTOL, f"15(b) losses (2,2) vs (1,1): {rel}"
        log(f"sharded  : 15(b) {first}")
        log(f"sharded  : 15(b) xlstm_125m (2,2) losses {a} vs (1,1) {b}"
            f"{' (phase 11(d))' if plain_losses else ''}: "
            f"step 0 rel {rel0:.2e} (limit {SHARD_LOSS0_RTOL:g}), max rel "
            f"{rel:.2e} (limit {SHARD_LOSS_RTOL:g}); {sec:.1f} s vs "
            f"{sec1:.1f} s wall")
        log(f"sharded  : 15(b) {ranks}")
        latest = checkpoint.latest_step(d)
        assert latest is not None and latest < SHARD_DIE_AT, latest
        rc2, out2, sec2 = shard_cli(base + once + [
            "--mesh-shape", "2,1", "--ckpt-dir", d], env)
        assert rc2 == 0 and f"resumed from step {latest} (elastic remesh ok)" \
            in out2 and out2.rstrip().endswith("done."), \
            f"15(b) restart on 2,1: rc {rc2}"
        log(f"sharded  : 15(b) killed at step {SHARD_DIE_AT} (rc 42 from "
            f"every rank), latest committed step {latest}; restarted on "
            f"(2,1): resumed from step {latest}, done ({sec2:.1f} s)")
        return dict(losses={"2,2": a, "1,1": b}, max_rel=rel, step0_rel=rel0,
                    seconds={"2,2": sec, "1,1": sec1}, backend_line=first,
                    ranks_line=ranks, killed_rc=rc, latest=latest,
                    resumed=latest,
                    restart_ranks=next(x for x in out2.splitlines()
                                       if x.startswith("ranks ")))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def shard_mesh_llama(dev, cfg, backend: str, plain_losses=None,
                     plain_gnorms=None) -> dict:
    """15(c): ``cfg`` trained SHARD_LLAMA_STEPS steps on a (1, 1)
    DeviceMesh of a world of one (``backend``): DTensor parameters, moments
    and residuals, the sharded step with B5's round trip on the local
    shards (one launch a step, asserted). Its losses are held to the plain
    path's: ``plain_losses`` where given (phase 8's first steps: the same
    seed, configs and batches), else a plain run made here first."""
    import gc

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.data import host_batch
    from repro_torch.kernels import cuda as C
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.launch.shardings import rules_for, train_state_specs
    from repro_torch.models.sharding import logical_rules
    from repro_torch.train import init_train_state, make_train_step

    ocfg, ccfg, dcfg = train_configs(cfg)
    out = {}
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        paths = ("plain", "mesh") if plain_losses is None else ("mesh",)
        for path in paths:
            ctx, shardings = contextlib.nullcontext(), None
            if path == "mesh":
                mesh = compat_make_mesh((1, 1), ("data", "model"), dev)
                rules = rules_for(cfg, mesh, "train_4k")
                shardings = train_state_specs(cfg, ocfg, ccfg, mesh,
                                              rules)[0]
                ctx = logical_rules(rules, mesh)
            state = init_train_state(cfg, ocfg, ccfg, seed=0, device=dev,
                                     shardings=shardings)
            assert isinstance(state["params"].embed, DTensor) == (
                path == "mesh")
            step_fn = make_train_step(cfg, ocfg, ccfg)
            losses, gnorms, ms, rts = [], [], [], []
            with ctx:
                for step in range(SHARD_LLAMA_STEPS):
                    batch = {k: torch.from_numpy(v).to(dev)
                             for k, v in host_batch(dcfg, step).items()}
                    before = dict(C.LAUNCHES)
                    sync(dev)
                    t = time.perf_counter()
                    state, m = step_fn(state, batch)
                    losses.append(float(m["loss"]))
                    gnorms.append(float(m["grad_norm"]))
                    sync(dev)
                    ms.append(1e3 * (time.perf_counter() - t))
                    rts.append(_launch_deltas(before, ("ef_roundtrip",))[
                        "ef_roundtrip"])
            if torch.device(dev).type == "cuda":
                assert rts == [1] * SHARD_LLAMA_STEPS, f"15(c) {path}: {rts}"
            out[path] = dict(losses=losses, grad_norms=gnorms, step_ms=ms,
                             roundtrips=rts)
            del state, step_fn
            gc.collect()
            if torch.device(dev).type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    if plain_losses is not None:
        out["plain"] = dict(losses=list(plain_losses),
                            grad_norms=list(plain_gnorms), from_phase=8)
    a, b = out["mesh"]["losses"], out["plain"]["losses"]
    assert len(a) == len(b) == SHARD_LLAMA_STEPS, (a, b)
    rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    assert rel <= SHARD_MESH_RTOL, f"15(c) mesh vs plain losses: {rel}"
    out.update(max_rel=rel, bitwise=a == b, arch=cfg.name,
               layers=cfg.n_layers, backend=backend)
    src = "phase 8's" if plain_losses is not None else "plain"
    plain_ms = out["plain"].get("step_ms")
    log(f"sharded  : 15(c) {cfg.name} ({cfg.n_layers} layers) on a (1,1) "
        f"{backend} DeviceMesh: losses {a} vs {src} {b} "
        f"({'bitwise' if a == b else f'max rel {rel:.2e}'}); step ms mesh "
        f"{[round(x, 1) for x in out['mesh']['step_ms']]}"
        + (f" plain {[round(x, 1) for x in plain_ms]}" if plain_ms else "")
        + f"; B5 round trips {out['mesh']['roundtrips']}")
    return out


def _tp_batches(dcfg, dev, steps: int) -> list:
    import torch

    from repro_torch.data import host_batch

    return [{k: torch.from_numpy(v).to(dev)
             for k, v in host_batch(dcfg, step).items()}
            for step in range(steps)]


def tp_ranks(rank, world, dev, specs) -> list:
    """15(e)'s runs on one rank, one after the other: :func:`tp_rank` of
    each ``(cfg, arch, total_steps, batch, seq)``, the card's cached
    blocks handed back between them."""
    out = []
    for spec in specs:
        out.append(tp_rank(rank, world, dev, *spec))
        gc_cuda()
    return out


def tp_rank(rank, world, dev, cfg, arch, total_steps, batch, seq,
            steps=SHARD_TP_STEPS) -> dict:
    """15(e) on one rank of a (1, world) mesh sharing the card: ``cfg``
    trained ``steps`` steps through ``make_train_step`` on the state
    ``init_train_state`` places, the train CLI's configs for
    ``arch`` over ``total_steps`` (the one-process run's), ``batch`` x
    ``seq`` tokens a step (the whole batch: one data rank). Returns the
    losses, ms a step (host clock, synced), this rank's state bytes and
    peak allocated bytes, its legs a step (calls, bytes; the steps after
    the first), the split and its B5 round trips."""
    import torch

    from repro_torch.kernels import cuda as C
    from repro_torch.launch import mesh as M
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.launch.shardings import (rules_for, split_plan,
                                              train_state_specs)
    from repro_torch.launch.train import local_state_bytes
    from repro_torch.launch.train import train_configs as cli_configs
    from repro_torch.models.sharding import logical_rules
    from repro_torch.train import init_train_state, make_train_step

    ocfg, ccfg, dcfg, _ = cli_configs(cfg, arch=arch, steps=total_steps,
                                      global_batch=batch, seq=seq)
    mesh = compat_make_mesh((1, world), ("data", "model"), dev)
    rules = rules_for(cfg, mesh, "train_4k")
    shardings, _ = train_state_specs(cfg, ocfg, ccfg, mesh, rules)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, ocfg, ccfg, seed=0, device=dev,
                             shardings=shardings)
    step_fn = make_train_step(cfg, ocfg, ccfg)
    batches = _tp_batches(dcfg, dev, steps)
    C.reset_launches()
    losses, gnorms, ms = [], [], []
    with logical_rules(rules, mesh):
        for step, b in enumerate(batches):
            if step == 1:
                M.reset_legs()
            sync(dev)
            t = time.perf_counter()
            state, m = step_fn(state, b)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            sync(dev)
            ms.append(1e3 * (time.perf_counter() - t))
    from repro_torch.optim.compress import compressed_leaves
    from repro_torch.train.step import ef_border_split, ef_local_split

    res = state["residuals"]
    aligned, gathered = ef_local_split(res, compressed_leaves(
        dict(state["params"].named_parameters()), res, ccfg,
        len(cfg.pattern)), ccfg.block)
    bordered, gathered = ef_border_split(res, gathered, ccfg.block)
    n = max(steps - 1, 1)
    return dict(losses=losses, grad_norms=gnorms, step_ms=ms,
                gathered=gathered, bordered=bordered,
                roundtrip_calls=bool(aligned or bordered) + bool(gathered),
                state_bytes=local_state_bytes(state),
                peak_bytes=(torch.cuda.max_memory_allocated()
                            if torch.device(dev).type == "cuda" else 0),
                legs={k: (c // n, b // n) for k, (c, b) in
                      sorted(M.LEGS.items())},
                split=split_plan(cfg, dict(
                    state["params"].named_parameters()))["kinds"],
                roundtrips=C.LAUNCHES["ef_roundtrip"])


def tp_plain_run(dev, cfg, arch, total_steps, batch, seq,
                 steps=SHARD_TP_STEPS) -> tuple:
    """(losses, gradient norms) of the one-process run 15(e) is held to,
    where no earlier phase gave them (``--only sharded``): the same
    configs, seed and batches."""
    from repro_torch.launch.train import train_configs as cli_configs
    from repro_torch.train import init_train_state, make_train_step

    ocfg, ccfg, dcfg, _ = cli_configs(cfg, arch=arch, steps=total_steps,
                                      global_batch=batch, seq=seq)
    state = init_train_state(cfg, ocfg, ccfg, seed=0, device=dev)
    step_fn = make_train_step(cfg, ocfg, ccfg)
    losses, gnorms = [], []
    for b in _tp_batches(dcfg, dev, steps):
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    del state, step_fn
    gc_cuda()
    return losses, gnorms


def one_process_state_bytes(cfg, ccfg) -> int:
    """The bytes :func:`launch.train.local_state_bytes` counts for ``cfg``
    in one process: parameters, f32 moments and residuals."""
    from repro_torch.models.model import Model

    r = train_state_bytes(cfg, ccfg)
    grads = sum(p.numel() * p.element_size()
                for p in Model(cfg, "meta").parameters())
    return r["state"] - grads


def shard_tp(dev, runs, world=2) -> dict:
    """15(e): each of ``runs`` (``(tag, cfg, arch, total steps, batch,
    seq, the one-process run's (losses, gradient norms) or None)``)
    trained on ``world`` spawned ranks of a (1, world) mesh sharing the
    card, held to the one-process run; returns each run's ranks and
    checks."""
    from repro_torch.launch.shardings import split_text
    from repro_torch.launch.train import train_configs as cli_configs

    plains = [plain or tp_plain_run(dev, cfg, arch, total, batch, seq)
              for _, cfg, arch, total, batch, seq, plain in runs]
    gc_cuda()
    t = time.perf_counter()
    by_rank = spawn_ranks(tp_ranks, world, dev,
                          [r[1:6] for r in runs])   # one spawn for all runs
    wall = time.perf_counter() - t
    out = {}
    for i, (tag, cfg, arch, total, batch, seq, _) in enumerate(runs):
        want, want_gn = plains[i]
        ranks = [r[i] for r in by_rank]
        got = ranks[0]["losses"]
        assert all(r["losses"] == got for r in ranks), \
            f"15(e) {tag}: the ranks' losses differ"
        assert all(math.isfinite(x) for x in got), got
        rel0 = abs(got[0] - want[0]) / abs(want[0])
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        assert rel0 <= SHARD_TP_LOSS0_RTOL, f"15(e) {tag} step 0: {rel0}"
        gn = ranks[0]["grad_norms"][0]
        gn_rel = abs(gn - want_gn[0]) / abs(want_gn[0])
        assert gn_rel <= SHARD_TP_GNORM0_RTOL, \
            f"15(e) {tag} step 0 gradient norm: {gn} vs {want_gn[0]}"
        assert rel <= SHARD_TP_LOSS_RTOL, f"15(e) {tag} losses: {rel}"
        _, ccfg, _, _ = cli_configs(cfg, arch=arch, steps=total)
        whole = one_process_state_bytes(cfg, ccfg)
        shares = [r["state_bytes"] / whole for r in ranks]
        lo, hi = SHARD_TP_STATE_SHARE
        assert all(lo <= x <= hi for x in shares), f"15(e) {tag}: {shares}"
        split = ranks[0]["split"]
        assert all(split.values()), f"15(e) {tag}: {split}"
        assert "train.param_all_gather" not in ranks[0]["legs"], \
            ranks[0]["legs"]
        # one B5 round trip a step on the local shards (those whose blocks
        # straddle the ranks' border extended by their neighbours'
        # columns), and one more on the whole leaves narrower than a
        # block a rank (C26)
        rts = [r["roundtrips"] for r in ranks]
        if "cuda" in str(dev):
            want_rt = [SHARD_TP_STEPS * r["roundtrip_calls"] for r in ranks]
            assert rts == want_rt, f"15(e) {tag}: {rts} != {want_rt}"
        steady = [sorted(r["step_ms"][1:])[len(r["step_ms"][1:]) // 2]
                  for r in ranks]
        out[tag] = dict(arch=cfg.name, layers=cfg.n_layers,
                        experts=cfg.n_experts, losses=got, one_process=want,
                        step0_rel=rel0, max_rel=rel,
                        grad_norms=ranks[0]["grad_norms"],
                        one_process_grad_norms=want_gn, gnorm0_rel=gn_rel,
                        whole_state=whole,
                        state_bytes=[r["state_bytes"] for r in ranks],
                        state_share=shares,
                        peak_bytes=[r["peak_bytes"] for r in ranks],
                        step_ms=[r["step_ms"] for r in ranks],
                        ms_per_step=steady, legs=ranks[0]["legs"],
                        split=split, roundtrips=rts,
                        roundtrip_gathered=ranks[0]["gathered"],
                        roundtrip_bordered=ranks[0]["bordered"])
        gib = 1e9
        log(f"sharded  : 15(e) {cfg.name} ({cfg.n_layers} layers"
            + (f", {cfg.n_experts} experts" if cfg.n_experts else "")
            + f") on (1,{world}), {world} ranks sharing the card: "
            f"{split_text(dict(model=world, kinds=split))}; losses {got} vs "
            f"one process {want}: step 0 rel {rel0:.2e} (limit "
            f"{SHARD_TP_LOSS0_RTOL:g}), max rel {rel:.2e} (limit "
            f"{SHARD_TP_LOSS_RTOL:g}); step 0 gradient norm {gn:.6g} vs "
            f"{want_gn[0]:.6g}, rel {gn_rel:.2e} (limit "
            f"{SHARD_TP_GNORM0_RTOL:g})")
        log(f"sharded  : 15(e) {cfg.name}: state per rank "
            f"{[round(r['state_bytes'] / gib, 2) for r in ranks]} GB of "
            f"{whole / gib:.2f} in one process "
            f"({[round(x, 4) for x in shares]}); peak per rank "
            f"{[round(r['peak_bytes'] / gib, 2) for r in ranks]} GB; ms a "
            f"step {[[round(x, 1) for x in r['step_ms']] for r in ranks]}; "
            f"B5 round trips {rts} (across the border: "
            f"{ranks[0]['bordered'] or 'none'}; on the whole leaf, C26: "
            f"{ranks[0]['gathered'] or 'none'})")
        log(f"sharded  : 15(e) {cfg.name} legs a step (rank 0: calls, "
            f"bytes): " + ", ".join(f"{k} {c} {b}" for k, (c, b) in
                                    ranks[0]["legs"].items()))
    log(f"sharded  : 15(e) {len(runs)} runs on one spawn of {world} ranks: "
        f"{wall:.1f} s wall")
    out["wall_s"] = wall
    return out


def sharded_phase(dev, *, psum_leaves=None, sketch_kw=None,
                  packets=SHARD_PACKETS, flows=N_FLOWS, batch=BATCH,
                  llama_cfg=None, full_xlstm=True, mesh_backend="nccl",
                  plain_losses=None, plain_gnorms=None, xlstm_losses=None,
                  scout_run=None, tp_runs=None) -> dict:
    """Phase 15: (a) compressed_psum on 2 ranks sharing the card, (b) the
    sharded CLI and its elastic restart, (c) llama3.2-3b on a (1,1) mesh,
    (d) the row-sharded sketch, (e) model-axis parallel training of
    llama3.2-3b and scout on (1,2). Each part's launch counts are read
    from its own processes, counted from 0 before it runs.
    ``plain_losses`` / ``plain_gnorms``: phase 8's first losses and
    gradient norms, which (c) and (e) hold their runs to instead of
    training the plain path again; ``xlstm_losses``: phase 11(d)'s, which
    (b) holds its (2,2) run to instead of a (1,1) run; ``scout_run``:
    phase 13's first (losses, gradient norms), which (e) holds scout to;
    ``tp_runs``: (e)'s runs in place of the full-width ones (the CPU
    rehearsal)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import full_config
    from repro_torch.kernels import cuda as C
    from repro_torch.sketch import F2PSketch, SketchConfig

    t0 = time.perf_counter()
    out, launches, parts = {}, {}, {}

    def part(name):
        parts[name] = round(time.perf_counter() - t0 - sum(parts.values()),
                            1)

    # (a)
    leaves = psum_leaves or SHARD_PSUM_LEAVES
    ranks = spawn_ranks(psum_rank, 2, dev, leaves)
    out["psum"] = {tag: {("packed" if p else "unpacked"): {
        k: v for k, v in ranks[0][tag][p].items()} for p in (False, True)}
        for tag, _ in leaves}
    for r, res in enumerate(ranks):
        for tag, _ in leaves:
            for p in (False, True):
                for k, n in res[tag][p]["launches"].items():
                    launches[k] = launches.get(k, 0) + n
                    if torch.device(dev).type == "cuda":
                        want = int(k == ("quantize_packed" if p else
                                         "quantize")) + int(
                            k == ("dequantize_packed" if p else "dequantize"))
                        assert n == want, (tag, p, r, k, n)
    out["host_staged"] = ranks[0]["host_staged"]
    for tag, shape in leaves:
        u, p = out["psum"][tag]["unpacked"], out["psum"][tag]["packed"]
        log(f"sharded  : 15(a) compressed_psum {tag} {list(shape)} f32, W=2 "
            f"ranks on one card: unpacked {u['ms']:.2f} ms, packed "
            f"{p['ms']:.2f} ms a call; each rank's shard quantize (B5 / B3) "
            f"and the gathered dequantize (B6 / B4) == plain, result == the "
            f"plain composition, packed == unpacked, bitwise; max |err| vs "
            f"the f32 mean {u['max_abs_err']:.3e} (within the codec bound)")
    log(f"sharded  : 15(a) legs staged through host memory by design "
        f"(gloo moves CPU tensors): {', '.join(out['host_staged'])}")
    part("a")
    # (b)
    out["cli"] = shard_train_cli(dev, full=full_xlstm,
                                 plain_losses=xlstm_losses)
    part("b")
    # (c)
    cfg = llama_cfg or full_config(ARCH)
    out["mesh_llama"] = shard_mesh_llama(dev, cfg, mesh_backend,
                                         plain_losses, plain_gnorms)
    launches["ef_roundtrip"] = sum(out["mesh_llama"]["mesh"]["roundtrips"])
    part("c")
    # (d)
    skw = sketch_kw or SKETCH
    ranks = spawn_ranks(sketch_rank, 2, dev, skw, packets, flows, batch)
    trace = torch.from_numpy(make_trace(packets, flows, seed=0))
    ref = F2PSketch(SketchConfig(**skw), device=dev)
    for pos in range(0, trace.numel(), batch):
        ref.update(trace[pos:pos + batch].to(dev))
    ref.flush()
    want_state, want_est = ref.state.cpu().numpy(), ref.estimates()
    for r, res in enumerate(ranks):
        assert np.array_equal(res["state"], want_state), \
            f"15(d) rank {r}: sharded state != the unsharded sketch's"
        assert np.array_equal(res["estimates"], want_est)
        assert res["fill"] == ref.fill() and res["arrivals"] == ref.arrivals
        for k, n in res["launches"].items():
            launches[k] = launches.get(k, 0) + n
    out["sketch"] = dict(
        rows={r: res["rows"] for r, res in enumerate(ranks)},
        lane_base={r: res["lane_base"] for r, res in enumerate(ranks)},
        launches={r: res["launches"] for r, res in enumerate(ranks)},
        seconds={r: res["seconds"] for r, res in enumerate(ranks)},
        packets=packets, fill=ref.fill())
    log(f"sharded  : 15(d) sketch {skw['depth']} x {skw['width']} "
        f"{skw['n_bits']}-bit on 2 ranks of {ranks[0]['rows'][0]} rows, "
        f"{packets} packets: state == the unsharded sketch's, bitwise; "
        f"launches per rank (B9, B10) "
        f"{[tuple(r['launches'].values()) for r in ranks]}; "
        f"{[round(r['seconds'], 2) for r in ranks]} s per rank")
    del ref, trace
    part("d")
    # (e)
    if tp_runs is None:
        scout = full_config(MOE_ARCHS[0])
        scout = dataclasses.replace(scout, n_layers=len(scout.pattern),
                                    n_experts=MOE_TRAIN_EXPERTS)
        plain = out["mesh_llama"]["plain"]
        tp_runs = (("llama", cfg, ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                    (plain["losses"], plain["grad_norms"])),
                   ("scout", scout, MOE_ARCHS[0], MOE_TRAIN_STEPS,
                    TRAIN_BATCH, TRAIN_SEQ, scout_run))
    out["tp"] = shard_tp(dev, tp_runs)
    launches["ef_roundtrip"] += sum(sum(r["roundtrips"])
                                    for t, r in out["tp"].items()
                                    if t != "wall_s")
    part("e")
    for k in ("quantize", "dequantize", "quantize_packed",
              "dequantize_packed", "ef_roundtrip", "counter_advance",
              "counter_estimate"):
        assert launches.get(k, 0) > 0 or torch.device(dev).type != "cuda", \
            f"phase 15 never launched {k}"
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    out["seconds_by_part"] = parts
    log(f"sharded  : phase 15 in {out['seconds']:.1f} s ({parts}); "
        f"launches {launches}")
    return out


def sharded_summary(sh: dict) -> dict:
    return dict(psum={t: {m: {k: v[k] for k in ("ms", "max_abs_err",
                                                 "launches")}
                          for m, v in x.items()}
                      for t, x in sh["psum"].items()},
                host_staged=sh["host_staged"],
                cli={k: sh["cli"][k] for k in ("losses", "max_rel",
                                               "seconds", "backend_line",
                                               "ranks_line", "latest")},
                mesh_llama={k: sh["mesh_llama"][k] for k in (
                    "max_rel", "bitwise", "layers", "backend")},
                mesh_losses=sh["mesh_llama"]["mesh"]["losses"],
                plain_losses=sh["mesh_llama"]["plain"]["losses"],
                mesh_step_ms=sh["mesh_llama"]["mesh"]["step_ms"],
                sketch=sh["sketch"],
                tp={t: {k: r[k] for k in (
                    "arch", "layers", "experts", "losses", "one_process",
                    "step0_rel", "max_rel", "whole_state", "state_bytes",
                    "state_share", "peak_bytes", "ms_per_step", "legs",
                    "split", "roundtrips", "roundtrip_gathered",
                    "roundtrip_bordered")}
                    if t != "wall_s" else r for t, r in sh["tp"].items()},
                launches=sh["launches"], seconds=sh["seconds"])


# ---------------------------------------------------------------------------
# phase 16: the launch analysis tools (A14)
# ---------------------------------------------------------------------------
# (a) the cells the op analysis counts on the card and on fake CPU tensors:
# phase 8's train step (rows x seq) and a decode step of the serving cell's
# 8 slots over packed caches of 1024 positions (the copy-in engine's fused
# attention) at position 512 (launch.dryrun.device_cell); (b) the dry run's
# cells on the single-pod fake world and the hillclimb variant run at decode
ANALYSIS_TRAIN = (TRAIN_BATCH, TRAIN_SEQ)
ANALYSIS_DECODE = (8, 1024)
ANALYSIS_CELLS = ("decode_32k", "train_4k")
ANALYSIS_VARIANT = "fsdp"
# the counts' agreement, card against fake: FLOPs equal, bytes within this
# share; the measured step at least this share of max(t_compute, t_memory)
ANALYSIS_BYTES_RTOL, ANALYSIS_BOUND_SHARE = 0.01, 0.9


def analysis_cell(dev, kind: str) -> dict:
    """One cell of 16(a): the op analysis of the step on the card (real
    tensors: the kernels launch and are charged through kernels/cost.py),
    the same cell on fake CPU tensors, and the step timed alone (CUDA
    events after a synchronize): FLOPs must agree exactly, bytes within
    ANALYSIS_BYTES_RTOL, and the measured step must be at least
    ANALYSIS_BOUND_SHARE of its roofline bound max(t_compute, t_memory)."""
    import gc

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import roofline as RL
    from repro_torch.launch.dryrun import device_cell
    from repro_torch.launch.op_analysis import analyze

    rows, seq = ANALYSIS_TRAIN if kind == "train" else ANALYSIS_DECODE
    iters = 3 if kind == "train" else 20
    t0 = time.perf_counter()
    step, args = device_cell(ARCH, kind, rows, seq, device=dev)
    ms = cuda_ms(lambda: step(*args), iters=iters, warm=1)
    sync(dev)
    _, card = analyze(step, *args)
    sync(dev)
    del step, args
    gc.collect()
    torch.cuda.empty_cache()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = device_cell(ARCH, kind, rows, seq, device="cpu",
                                 fake=True)
        _, fake = analyze(step, *args, fake=True)
    del step, args
    fake_s = time.perf_counter() - t0
    t_compute = card["flops"] / RL.PEAK_FLOPS * 1e3
    t_memory = card["hbm_bytes"] / RL.HBM_BW * 1e3
    rel = abs(card["hbm_bytes"] - fake["hbm_bytes"]) / fake["hbm_bytes"]
    r = dict(kind=kind, rows=rows, seq=seq, ms=ms, t_compute_ms=t_compute,
             t_memory_ms=t_memory, bound_ms=max(t_compute, t_memory),
             flops=card["flops"], fake_flops=fake["flops"],
             hbm_bytes=card["hbm_bytes"], fake_hbm_bytes=fake["hbm_bytes"],
             bytes_rel_diff=rel, temp_bytes=card["temp_size_in_bytes"],
             fake_temp_bytes=fake["temp_size_in_bytes"],
             argument_bytes=card["argument_size_in_bytes"],
             kernels=card["kernels"], fake_kernels=fake["kernels"],
             card_s=card_s, fake_s=fake_s,
             top_ops=dict(sorted(card["by_op"].items(),
                                 key=lambda kv: -kv[1]["bytes"])[:6]))
    log(f"analysis : {kind:6s} {rows} x {seq}: measured {ms:.3f} ms | "
        f"t_compute {t_compute:.3f} ms ({card['flops']:.6e} FLOPs), "
        f"t_memory {t_memory:.3f} ms ({card['hbm_bytes']:.6e} B) | fake "
        f"{fake['flops']:.6e} FLOPs, {fake['hbm_bytes']:.6e} B (bytes "
        f"{rel:.2e} apart) | temp {card['temp_size_in_bytes']} B card, "
        f"{fake['temp_size_in_bytes']} B fake | kernels "
        f"{ {k: v['count'] for k, v in card['kernels'].items()} } | "
        f"{card_s:.1f} s card, {fake_s:.1f} s fake")
    assert card["flops"] == fake["flops"] > 0, \
        f"{kind}: card {card['flops']} FLOPs, fake {fake['flops']}"
    assert rel <= ANALYSIS_BYTES_RTOL, f"{kind}: bytes {rel:.3e} apart"
    assert card["kernels"].keys() == fake["kernels"].keys(), \
        (card["kernels"], fake["kernels"])
    assert ms >= ANALYSIS_BOUND_SHARE * r["bound_ms"], \
        f"{kind}: {ms:.3f} ms measured under its bound {r['bound_ms']:.3f}"
    return r


def analysis_phase(dev, *, cells=ANALYSIS_CELLS,
                   variant=ANALYSIS_VARIANT) -> dict:
    """Phase 16: (b) the dry run of llama3.2-3b's ``cells`` on the
    single-pod fake world, each through ``python -m
    repro_torch.launch.dryrun`` (one process a cell, on the CPU, started
    first and run beside (a)), then ``launch.report`` over their records and
    one ``launch.hillclimb`` variant at decode; (a) the op analysis of a
    real train and decode step on the card against the same cells on fake
    tensors (analysis_cell). Records land in chiprun_out/analysis/."""
    import os
    import shutil

    out = ROOT / "chiprun_out" / "analysis"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmds = {c: [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                ARCH, "--shape", c, "--mesh", "single", "--out",
                str(out / "dryrun")] for c in cells}
    cmds["hillclimb"] = [sys.executable, "-m", "repro_torch.launch.hillclimb",
                         "--arch", ARCH, "--shape", cells[0], "--variant",
                         variant, "--out", str(out / "perf")]
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(v, env=env, cwd=str(ROOT),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, v in cmds.items()}
    res = {"device": smi_line()}
    try:
        res["cells"] = {k: analysis_cell(dev, k) for k in ("train", "decode")}
        dry = {}
        for k, p in procs.items():
            text, _ = p.communicate(timeout=600)
            dry[k] = dict(rc=p.returncode, tail=text.strip().splitlines()[-3:])
            assert p.returncode == 0, f"{k}: rc {p.returncode}\n{text}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for c in cells:
        rec = json.loads((out / "dryrun" / f"{ARCH}__{c}__16x16.json")
                         .read_text())
        assert rec["status"] == "ok", rec
        dry[c].update({k: rec[k] for k in (
            "compile_s", "hlo_flops", "hlo_bytes", "collective_bytes",
            "t_compute", "t_memory", "t_collective", "bottleneck",
            "placement")})
        log(f"analysis : dry run {ARCH} {c} on 16x16: {rec['compile_s']} s "
            f"traced, t=({rec['t_compute']:.3e}, {rec['t_memory']:.3e}, "
            f"{rec['t_collective']:.3e}) s, {rec['bottleneck']}; "
            f"{rec['placement']}")
    hc = json.loads((out / "perf" / f"{ARCH}__{cells[0]}__{variant}.json")
                    .read_text())
    dry["hillclimb"].update(variant=variant, compile_s=hc["compile_s"],
                            bottleneck=hc["bottleneck"],
                            t_memory=hc["t_memory"],
                            t_collective=hc["t_collective"])
    log(f"analysis : hillclimb {cells[0]} --variant {variant}: "
        f"{hc['compile_s']} s, t_memory {hc['t_memory']:.3e} s, "
        f"t_collective {hc['t_collective']:.3e} s, {hc['bottleneck']}")
    rep = subprocess.run([sys.executable, "-m", "repro_torch.launch.report",
                          str(out / "dryrun")], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert rep.returncode == 0, rep.stderr
    (out / "report.md").write_text(rep.stdout)
    assert f"## Dry-run summary: {len(cells)} ok" in rep.stdout, rep.stdout
    for c in cells:
        assert f"| {ARCH} | {c} | ok |" in rep.stdout, c
    res["dryrun"] = dry
    log(f"analysis : report over {len(cells)} records ok "
        f"(chiprun_out/analysis/report.md); phase 16 "
        f"{time.perf_counter() - t0:.1f} s on {res['device']}")
    return res


def analysis_summary(an: dict) -> dict:
    keep = ("ms", "t_compute_ms", "t_memory_ms", "flops", "fake_flops",
            "hbm_bytes", "fake_hbm_bytes", "bytes_rel_diff", "temp_bytes")
    return {"device": an["device"],
            "cells": {k: {f: v[f] for f in keep}
                      for k, v in an["cells"].items()},
            "dryrun": {k: {f: v.get(f) for f in ("compile_s", "bottleneck",
                                                  "t_memory")}
                       for k, v in an["dryrun"].items()}}


def long_attention(dev, shapes=LONG_SHAPES, lengths=LONG_LENGTHS,
                   tiles=LONG_TILES, fmt_name="f2p_sr_2_8s") -> dict:
    """17(a): B1 (paged, a shuffled page table) and B2 (dense, over the
    gathered pages) at batch 1 over caches of each length in ``lengths``,
    at (kv heads, G, head_dim) in ``shapes``, kv_len S - 1 and 100, at each
    tile: paged == dense bitwise, the page table cut to the live span ==
    the dense call on the full cache, and the dense call within rtol =
    atol = 1e-5 of the plain version at the same tile. Timed at kv_len S -
    1: ms with the host (CUDA events around the wrapper), device ms
    (torch.profiler, the kernel alone), the bound (kernels/cost.py's bytes
    / 3.35 TB/s against 4 G hd f32 operations a position and kv head / 67
    TFLOP/s) and SDPA (enable_gqa) on the dequantized bf16 K/V of the live
    positions."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import qtensor as QT
    from repro_torch.core.formats import named_format
    from repro_torch.kernels import cost
    from repro_torch.kernels import f2p_attention as A

    fmt = named_format(fmt_name)
    cuda = torch.device(dev).type == "cuda"
    T, B = 8, 1
    rows = []
    for K, G, hd in shapes:
        for S in lengths:
            g = torch.Generator(device=dev).manual_seed(S + G)
            maxp = S // T
            P = maxp + 1
            slab_k, slab_v = (QT.quantize(torch.randn(
                P, T, K, hd, generator=g, device=dev), fmt, block=hd,
                packed=True) for _ in range(2))
            pages = torch.randperm(P, generator=g, device=dev)[:maxp]
            pages = pages[None].to(torch.int32)
            dk = A.gather_pages_to_dense(slab_k, pages)
            dv = A.gather_pages_to_dense(slab_v, pages)
            q = torch.randn(B, 1, K * G, hd, generator=g, device=dev)
            sdpa_ms = None
            if cuda:
                n = S - 1
                qs = q.transpose(1, 2).to(torch.bfloat16)
                kd = dk.dequantize(torch.bfloat16)[:, :n].transpose(1, 2)
                vd = dv.dequantize(torch.bfloat16)[:, :n].transpose(1, 2)
                sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qs, kd, vd, enable_gqa=True), iters=20)
                del kd, vd
            for tile in tiles:
                for kv_len in (S - 1, 100):
                    paged = A.attention_paged(q, slab_k, slab_v, pages,
                                              kv_len=kv_len, tile=tile)
                    dense = A.attention_packed(q, dk, dv, kv_len=kv_len,
                                               tile=tile)
                    assert torch.equal(paged, dense), \
                        f"B1 != B2 at S={S} K={K} G={G} tile {tile}"
                    span = -(-kv_len // T)
                    assert torch.equal(A.attention_paged(
                        q, slab_k, slab_v, pages[:, :span].contiguous(),
                        kv_len=kv_len, tile=tile), dense), \
                        f"cut page table != dense at S={S} tile {tile}"
                    t0 = time.perf_counter()
                    ref = A.attention_packed_plain(q, dk, dv, kv_len=kv_len,
                                                   tile=tile)
                    sync(dev)
                    plain_ms = (time.perf_counter() - t0) * 1e3
                    torch.testing.assert_close(dense, ref, rtol=1e-5,
                                               atol=1e-5)
                    err = float((dense - ref).abs().max())
                    plan = A.attention_plan(B, K, G, hd, S, tile)
                    r = dict(K=K, G=G, hd=hd, S=S, tile=tile, kv_len=kv_len,
                             splits=plan.nsplit,
                             live_splits=-(-kv_len // tile),
                             max_abs_err=err, plain_ms=plain_ms)
                    if cuda and kv_len == S - 1:
                        nb = cost.nbytes("attention_paged", q, slab_k,
                                         slab_v, pages, kv_len=kv_len)
                        ops = 4 * G * hd * kv_len * K * B
                        by_bytes = bound_ms(nb)
                        by_ops = ops / F32_OPS_PER_S * 1e3
                        for name, fn in (
                                ("attention_paged",
                                 lambda: A.attention_paged(
                                     q, slab_k, slab_v, pages, kv_len=kv_len,
                                     tile=tile)),
                                ("attention_packed",
                                 lambda: A.attention_packed(
                                     q, dk, dv, kv_len=kv_len, tile=tile))):
                            dms, _ = device_calls(
                                fn, "attention_decode_kernel", iters=10)
                            r[name] = dict(ms=cuda_ms(fn, iters=20),
                                           device_ms=dms)
                        r.update(bound_ms=max(by_bytes, by_ops),
                                 bytes_bound_ms=by_bytes, ops_bound_ms=by_ops,
                                 bound_by="bytes" if by_bytes >= by_ops
                                 else "operations", bytes=nb,
                                 sdpa_ms=sdpa_ms)
                        log(f"long     : B1/B2 K={K} G={G} hd={hd} S={S} "
                            f"tile {tile} ({plan.nsplit} splits): paged "
                            f"{r['attention_paged']['ms']:.5f} ms (device "
                            f"{_ms(r['attention_paged']['device_ms'])}), "
                            f"dense {r['attention_packed']['ms']:.5f} "
                            f"(device "
                            f"{_ms(r['attention_packed']['device_ms'])}); "
                            f"bound {r['bound_ms']:.5f} ({r['bound_by']}), "
                            f"SDPA bf16 {sdpa_ms:.5f}, plain "
                            f"{plain_ms:.1f}; max |err| {err:.2e}")
                    rows.append(r)
            del slab_k, slab_v, dk, dv
            gc_cuda()
    log(f"long     : B1/B2 at S {lengths}, tiles {tiles}, kv_len S - 1 and "
        f"100: paged == dense == the cut page table bitwise, within 1e-5 "
        f"of the plain version ({len(rows)} cases)")
    return dict(rows=rows, merge=merge_probe(dev, rows, shapes[0],
                                             max(lengths), tiles)
                if cuda else None)


def merge_probe(dev, rows, shape, S, tiles, fmt_name="f2p_sr_2_8s") -> dict:
    """The split merge's share of a long call, estimated: the last CTA of
    a (head, group) merges every split of it, one such CTA per kv head,
    all at once; so one kv head (T1: an eighth of the pass, the whole
    merge) against eight (T8: the pass and the same merge) gives merge =
    (8 T1 - T8) / 7, from the dense call's device time at kv_len S - 1."""
    import torch

    from repro_torch.core import qtensor as QT
    from repro_torch.core.formats import named_format
    from repro_torch.kernels import f2p_attention as A

    K, G, hd = shape
    fmt = named_format(fmt_name)
    g = torch.Generator(device=dev).manual_seed(5)
    kq, vq = (QT.quantize(torch.randn(1, S, 1, hd, generator=g, device=dev),
                          fmt, block=hd, packed=True) for _ in range(2))
    q = torch.randn(1, 1, G, hd, generator=g, device=dev)
    out = {}
    for tile in tiles:
        t1, _ = device_calls(lambda: A.attention_packed(
            q, kq, vq, kv_len=S - 1, tile=tile), "attention_decode_kernel",
            iters=10)
        t8 = next(r["attention_packed"]["device_ms"] for r in rows
                  if (r["K"], r["G"], r["hd"], r["S"], r["tile"]) ==
                  (K, G, hd, S, tile) and "attention_packed" in r)
        est = (K * t1 - t8) / (K - 1) if t1 and t8 else None
        out[tile] = dict(one_head_device_ms=t1, heads_device_ms=t8,
                         merge_ms=est, splits=-(-S // tile))
        log(f"long     : merge at S={S}, tile {tile} ({-(-S // tile)} "
            f"splits): one kv head {_ms(t1)} ms, {K} heads {_ms(t8)} ms on "
            f"the device; the merge about {_ms(est)} ms")
    del kq, vq
    return out


def fill_kv(caches, seed: int, dev) -> None:
    """Every attention position's dense K and V cache filled through B3
    (its packed quantize) from seeded normal values, layer group by group."""
    import torch

    from repro_torch.core import qtensor as QT

    g = torch.Generator(device=dev).manual_seed(seed)
    for c in caches.values():
        if "k" not in c:
            continue
        for kv in ("k", "v"):
            qt = c[kv]
            G, B, S, K, hd = qt.shape
            for i in range(G):
                x = torch.randn(B, S, K, hd, generator=g, device=dev,
                                dtype=torch.bfloat16)
                part = QT.quantize(x, qt.fmt, block=qt.block, packed=True)
                qt.codes[i].view(torch.int32).copy_(
                    part.codes.view(torch.int32))
                qt.scales[i].copy_(part.scales)
                del x, part


def long_decode(dev, cfg, model, S, pos0, steps, tag, seed=31) -> dict:
    """17(c) / (d): one row deep in its context. Dense caches of S positions
    filled with seeded K/V (:func:`fill_kv`), the same words as pool slabs
    at a permutation (:func:`slabs_from_dense`), then ``steps`` greedy
    decode steps from ``pos0`` on each: logits bitwise equal at every step
    (asserted), ms per step. The dense run is the fused one (B2)."""
    import dataclasses
    import statistics

    import torch

    from repro_torch.models import init_caches

    cfg = dataclasses.replace(cfg, fused_attention=True)
    t0 = time.perf_counter()
    caches = init_caches(cfg, 1, S, quantized_kv=True, device=dev)
    fill_kv(caches, seed, dev)
    slabs, pages = slabs_from_dense(cfg, caches, None, 1, 8, dev)
    sync(dev)
    fill_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (1, 1), generator=g, device=dev)
    pos = torch.full((1,), pos0, dtype=torch.int64, device=dev)
    dense = greedy_decode(dev, model, cfg, caches, tok, pos, steps)
    paged = greedy_decode(dev, model, cfg, slabs, tok, pos, steps,
                          pages=pages)
    for i, (a, b) in enumerate(zip(dense["logits"], paged["logits"])):
        assert torch.equal(a, b), f"{tag}: paged != dense logits at step {i}"
        assert bool(torch.isfinite(a).all()), f"{tag}: logits not finite"
    med = {k: statistics.median(r["step_ms"]) if r["step_ms"] else None
           for k, r in (("dense", dense), ("paged", paged))}
    res = dict(S=S, positions=[pos0, pos0 + steps - 1], steps=steps,
               fill_s=fill_s, dense_step_ms=dense["step_ms"],
               paged_step_ms=paged["step_ms"],
               dense_median_ms=med["dense"], paged_median_ms=med["paged"],
               tokens=dense["tokens"][0].tolist(),
               launches={k: v for k, v in dense["counts"].items() if v},
               paged_launches={k: v for k, v in paged["counts"].items()
                               if v})
    log(f"long     : {tag}: cache of {S} positions filled in {fill_s:.1f} s; "
        f"{steps} greedy steps from position {pos0}: paged == dense logits "
        f"bitwise at every step; median {_ms(med['dense'])} ms a step dense, "
        f"{_ms(med['paged'])} paged; launches {res['launches']} / "
        f"{res['paged_launches']}")
    del caches, slabs
    gc_cuda()
    return res


def long_engines(dev, cfg, model, max_seq=LONG_MAX_SEQ, n_req=LONG_REQUESTS,
                 prompt=LONG_PROMPT, max_new=LONG_NEW) -> dict:
    """17(b): the paged and copy-in BatchedEngine and the sequential Engine,
    each built with ``max_seq`` positions a row (the copy-in and sequential
    engines hold dense caches of that length), on ``n_req`` requests of
    ``prompt`` tokens (a prefill bucket: no padding) and ``max_new`` new
    tokens, one slot: greedy tokens paged == copy-in == sequential
    (asserted), tok/s each."""
    import numpy as np
    import torch

    from repro_torch.kernels import cuda as C
    from repro_torch.serve import (BatchedEngine, BatchedServeConfig, Engine,
                                   Request, ServeConfig)

    rng = np.random.default_rng(30)
    reqs = [Request(uid=u + 1, tokens=rng.integers(
                0, cfg.vocab_size, prompt).astype(np.int32),
                max_new=max_new) for u in range(n_req)]
    n_pages = 2 * n_req * -(-(prompt + max_new) // 8) + 2
    res = {}
    outs = {}
    for tag, kw in (("paged", {}), ("copy_in", dict(paged_decode=False))):
        eng = BatchedEngine(cfg, BatchedServeConfig(
            slots=1, max_seq=max_seq, n_pages=n_pages, **kw), model)
        before = dict(C.LAUNCHES)
        sync(dev)
        t = time.perf_counter()
        outs[tag] = eng.run(reqs)
        sync(dev)
        dt = time.perf_counter() - t
        ntok = sum(len(v) for v in outs[tag].values())
        res[tag] = dict(tok_s=ntok / dt, seconds=dt, launches={
            k: C.LAUNCHES[k] - before[k] for k in C.LAUNCHES
            if C.LAUNCHES[k] - before[k]})
        del eng
        gc_cuda()
    seq = Engine(cfg, ServeConfig(batch=1, max_seq=max_seq,
                                  quantized_kv=True, fused_attention=True),
                 model)
    before = dict(C.LAUNCHES)
    t = time.perf_counter()
    outs["sequential"] = {r.uid: seq.generate(r.tokens[None], r.max_new)[0]
                          for r in reqs}
    sync(dev)
    dt = time.perf_counter() - t
    res["sequential"] = dict(
        tok_s=n_req * max_new / dt, seconds=dt,
        launches={k: C.LAUNCHES[k] - before[k] for k in C.LAUNCHES
                  if C.LAUNCHES[k] - before[k]})
    for r in reqs:
        p = outs["paged"][r.uid]
        assert len(p) == r.max_new, f"request {r.uid} short"
        for tag in ("copy_in", "sequential"):
            assert np.array_equal(np.asarray(outs[tag][r.uid]), p), \
                f"request {r.uid}: {tag} != paged at max_seq {max_seq}"
    if torch.device(dev).type == "cuda":
        assert res["paged"]["launches"].get("attention_paged", 0) > 0
        assert res["copy_in"]["launches"].get("attention_packed", 0) > 0
        assert res["sequential"]["launches"].get("attention_packed", 0) > 0
    log(f"long     : {cfg.name} engines at max_seq {max_seq}: {n_req} "
        f"requests x {max_new} tokens, paged == copy-in == sequential, "
        f"token for token; tok/s paged {res['paged']['tok_s']:.1f}, "
        f"copy-in {res['copy_in']['tok_s']:.1f}, sequential "
        f"{res['sequential']['tok_s']:.1f}")
    res["tokens"] = {u: np.asarray(v).tolist() for u, v in
                     outs["paged"].items()}
    return res


def long_autotune(dev) -> dict:
    """17(e): autotune_attention_tile("cuda", 8) and
    autotune_matmul_tiles("cuda", n) at 6 and 8 bits at their default
    shapes; each candidate also timed here (CUDA events) and printed, the
    kernel at the winner held to its plain version (attention rtol = atol
    = 1e-5; matmul rtol 1e-4, atol 1e-4 x max |y|), then both tables
    cleared so that later calls run at the defaults."""
    import inspect

    import numpy as np
    import torch

    from repro_torch.core import qtensor as QT
    from repro_torch.core.f2p import F2PFormat, Flavor
    from repro_torch.kernels import f2p_attention as A
    from repro_torch.kernels import f2p_matmul as M
    from repro_torch.kernels.bits import unpack_bits

    out = {}
    t0 = time.perf_counter()
    win = A.autotune_attention_tile("cuda", 8)
    tune_s = time.perf_counter() - t0
    assert A.attention_tile("cuda", 8) == win
    fmt = F2PFormat(8, 2, Flavor.SR, signed=True)
    B, S, K, hd = 2, 2048, 4, 128
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(B, 1, 2 * K, hd)).astype(
        np.float32)).to(dev)
    kq, vq = (QT.quantize(torch.from_numpy(rng.normal(
        size=(B, S, K, hd)).astype(np.float32)).to(dev), fmt, block=hd,
        packed=True) for _ in range(2))
    times = {t: cuda_ms(lambda t=t: A.attention_packed(
        q, kq, vq, kv_len=S - 1, tile=t), iters=50)
        for t in (64, 128, 256, 512)}
    got = A.attention_packed(q, kq, vq, kv_len=S - 1)       # the table's
    torch.testing.assert_close(got, A.attention_packed_plain(
        q, kq, vq, kv_len=S - 1, tile=win), rtol=1e-5, atol=1e-5)
    out["attention"] = dict(winner=win, ms=times, tune_s=tune_s)
    log(f"long     : autotune_attention_tile('cuda', 8) at (2, 2048, 4, "
        f"128): {win} in {tune_s:.2f} s; CUDA-event ms per tile "
        f"{ {t: round(v, 5) for t, v in times.items()} }; the kernel at "
        f"{win} within 1e-5 of the plain version")
    Mr, Kd, N = 256, 1024, 1024
    cand = inspect.signature(M.autotune_matmul_tiles).parameters[
        "candidates"].default
    for n_bits in (6, 8):
        f = F2PFormat(n_bits, 2, Flavor.SR, signed=True)
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(size=(Mr, Kd)).astype(
            np.float32)).to(dev)
        w = torch.from_numpy(rng.normal(size=(Kd, N)).astype(
            np.float32)).to(dev)
        words, scales = M.quantize_weight(w, f, packed=True)
        # the planner's launch (no entry yet), then each candidate's
        times = {"planner": cuda_ms(lambda: M.f2p_dequant_matmul_packed(
            x, words, scales, fmt=f), iters=50)}
        times.update({str(c): cuda_ms(lambda c=c: M.f2p_dequant_matmul_packed(
            x, words, scales, fmt=f, tiles=c), iters=50) for c in cand})
        t0 = time.perf_counter()
        win_m = M.autotune_matmul_tiles("cuda", n_bits)
        tune_s = time.perf_counter() - t0
        assert M.matmul_tiles("cuda", n_bits) == win_m
        y = M.f2p_dequant_matmul_packed(x, words, scales, fmt=f)  # table's
        ref = M.ref_dequant_matmul(x, unpack_bits(words, n_bits, N), scales,
                                   f)
        torch.testing.assert_close(y, ref, rtol=1e-4,
                                   atol=1e-4 * float(ref.abs().max()))
        out[f"matmul_{n_bits}"] = dict(winner=list(win_m), ms=times,
                                       tune_s=tune_s)
        log(f"long     : autotune_matmul_tiles('cuda', {n_bits}) at (256, "
            f"1024, 1024): {win_m} in {tune_s:.2f} s; CUDA-event ms "
            f"{ {k: round(v, 5) for k, v in times.items()} }; the kernel at "
            f"the winner within 1e-4 of the plain version")
    A._TILE_TABLE.clear()
    M._TILE_TABLE.clear()
    return out


def long_phase(dev) -> dict:
    """Phase 17: long-context decode. (a) B1/B2 at 32896, 131072 and 524288
    positions; then the launch counters are zeroed and the main path runs:
    (b) full-width llama3.2-3b's three engines at max_seq 131072, (c) one
    llama3.2-3b row at position 131064 of a full 131072-position cache,
    (d) the reference's long_500k cell for jamba (cut as in phase 11) at
    position 524287; the counters are read; (e) the two autotuners."""
    import dataclasses

    from repro_torch.configs import full_config
    from repro_torch.kernels import cuda as C
    from repro_torch.models import init_params

    t_phase = time.perf_counter()
    res = {"attention": long_attention(dev)}
    cfg = full_config("llama3_2_3b")
    model = init_params(cfg, seed=0, device=dev)
    C.reset_launches()
    res["engines"] = long_engines(dev, cfg, model)
    res["llama_decode"] = long_decode(
        dev, cfg, model, LONG_MAX_SEQ, LONG_MAX_SEQ - LONG_STEPS, LONG_STEPS,
        f"{cfg.name} at {LONG_MAX_SEQ}")
    del model
    gc_cuda()
    full = full_config("jamba_1_5_large")
    jcfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS,
                               n_experts=JAMBA_EXPERTS)
    t0 = time.perf_counter()
    model = init_params(jcfg, seed=0, device=dev)
    sync(dev)
    log(f"long     : {jcfg.name} cut to {JAMBA_LAYERS} layers and "
        f"{JAMBA_EXPERTS} of {full.n_experts} experts (phase 11's cut), "
        f"init {time.perf_counter() - t0:.1f} s")
    res["jamba_long_500k"] = long_decode(
        dev, jcfg, model, JAMBA_LONG_S, JAMBA_LONG_S - JAMBA_LONG_STEPS,
        JAMBA_LONG_STEPS, f"{jcfg.name} long_500k")
    del model
    gc_cuda()
    res["launches"] = {k: v for k, v in C.LAUNCHES.items() if v}
    for name in ("attention_paged", "attention_packed", "kv_write"):
        assert res["launches"].get(name, 0) > 0, \
            f"phase 17's main path never launched {name}"
    res["autotune"] = long_autotune(dev)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"long     : phase 17 in {res['seconds']:.1f} s; main-path launches "
        f"{res['launches']}")
    return res


def long_summary(lg: dict) -> dict:
    a = [r for r in lg["attention"]["rows"] if "attention_paged" in r]
    return dict(
        attention={f"K{r['K']}_G{r['G']}_S{r['S']}_t{r['tile']}": dict(
            paged_ms=r["attention_paged"]["ms"],
            paged_device_ms=r["attention_paged"]["device_ms"],
            dense_ms=r["attention_packed"]["ms"],
            dense_device_ms=r["attention_packed"]["device_ms"],
            bound_ms=r["bound_ms"], sdpa_ms=r["sdpa_ms"],
            max_abs_err=r["max_abs_err"]) for r in a},
        engines={k: lg["engines"][k]["tok_s"] for k in ("paged", "copy_in",
                                                         "sequential")},
        llama_decode_ms=[lg["llama_decode"]["dense_median_ms"],
                         lg["llama_decode"]["paged_median_ms"]],
        jamba_long_500k_ms=[lg["jamba_long_500k"]["dense_median_ms"],
                            lg["jamba_long_500k"]["paged_median_ms"]],
        autotune={k: v["winner"] for k, v in lg["autotune"].items()},
        launches=lg["launches"], seconds=lg["seconds"])


def main():
    import argparse
    import gc

    import torch

    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--only", choices=("matmul", "attention", "codec",
                                       "unpacked", "fl", "families",
                                       "recurrent", "frontends",
                                       "moe_train", "examples",
                                       "sharded", "analysis", "long"),
                    help="matmul / attention / codec / unpacked: phases 1-2 "
                         "and phase 3's dequant matmul (B7/B8), attention "
                         "(B1/B2), packed codec (B3/B4) or unpacked codec "
                         "(B5, its round trip, B6) only, the quick loop for "
                         "those kernels; fl: phases 1-2 and phase 9 (FL "
                         "and faults); families: phases 1-2 and phase 10 "
                         "(MoE and the other configs); recurrent: phases "
                         "1-2 and phase 11 (jamba, xLSTM); frontends: "
                         "phases 1-2 and phase 12 (whisper, internvl2); "
                         "moe_train: phases 1-2 and phase 13 (the MoE "
                         "family trained); examples: phases 1-2 and phase "
                         "14 (the example twins); sharded: phases 1-2 and "
                         "phase 15 (the sharded part); analysis: phases "
                         "1-2 and phase 16 (the launch analysis tools); "
                         "long: phases 1-2 and phase 17 (long-context "
                         "decode, the tile tables' autotuners); "
                         "prints no final ok line")
    only = ap.parse_args().only
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device — the port's kernels "
                         "run only on an NVIDIA GPU")
    from repro_torch.kernels import cuda as C

    dev = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"device   : {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    C.build()
    C.lib()
    log(f"build    : {time.perf_counter() - t0:.1f} s (nvcc "
        f"{C.build_seconds:.1f} s)")
    for line in C.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas  :", line.strip())
    if only == "attention":
        att = check_attention(dev)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_attention.json").write_text(json.dumps(
            {"device": smi, "attention": att}, indent=1, default=str))
        print(json.dumps({"attention": {k: {f: v[f] for f in (
            "ms", "device_ms", "cold_ms", "library_ms", "bound_ms",
            "splits", "live_ctas", "device_kernels_per_call",
            "max_abs_err", "digest")} for k, v in att.items()}}))
        print(smi)
        return
    if only == "codec":
        cod = check_codec(dev)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_codec.json").write_text(json.dumps(
            {"device": smi, "codec": cod}, indent=1, default=str))
        print(json.dumps({"codec": {k: {f: v.get(f) for f in (
            "ms", "device_ms", "cold_ms", "host_enqueue_ms", "plain_ms",
            "bound_ms", "max_abs_err")}
            for k, v in {**cod, **cod["dequantize_packed"]["rows"]}.items()
            if k != "dequantize_packed"}}))
        print(smi)
        return
    if only == "unpacked":
        unp = check_unpacked_codec(dev)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_unpacked.json").write_text(json.dumps(
            {"device": smi, "unpacked": unp}, indent=1, default=str))
        print(json.dumps({"unpacked": {k: {f: v.get(f) for f in (
            "ms", "device_ms", "ms_16bit", "device_ms_16bit",
            "composition_ms", "composition_device_ms", "plain_ms",
            "bound_ms", "max_abs_err")} for k, v in unp.items()}}))
        print(smi)
        return
    if only == "fl":
        fl = fl_phase(dev)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_fl.json").write_text(json.dumps(
            {"device": smi, "fl": fl}, indent=1, default=str))
        print(json.dumps({"fl": fl_summary(fl)}))
        print(smi)
        return
    if only == "families":
        fam = families_phase(dev)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_families.json").write_text(json.dumps(
            {"device": smi, "families": fam}, indent=1, default=str))
        print(json.dumps({"families": families_summary(fam)}, default=str))
        print(smi)
        return
    if only == "recurrent":
        rec = recurrent_phase(dev)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_recurrent.json").write_text(json.dumps(
            {"device": smi, "recurrent": rec}, indent=1, default=str))
        print(json.dumps({"recurrent": recurrent_summary(rec)}, default=str))
        print(smi)
        return
    if only == "frontends":
        fr = frontends_phase(dev)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_frontends.json").write_text(json.dumps(
            {"device": smi, "frontends": fr}, indent=1, default=str))
        print(json.dumps({"frontends": frontends_summary(fr)}, default=str))
        print(smi)
        return
    if only == "moe_train":
        mt = moe_train_phase(dev)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_moe_train.json").write_text(json.dumps(
            {"device": smi, "moe_train": mt}, indent=1, default=str))
        print(json.dumps({"moe_train": moe_train_summary(mt)}, default=str))
        print(smi)
        return
    if only == "sharded":
        sh = sharded_phase(dev)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_sharded.json").write_text(json.dumps(
            {"device": smi, "sharded": sh}, indent=1, default=str))
        print(json.dumps({"sharded": sharded_summary(sh)}, default=str))
        print(smi)
        return
    if only == "analysis":
        an = analysis_phase(dev)
        out_dir = ROOT / "chiprun_out"
        (out_dir / "chip_smoke_analysis.json").write_text(json.dumps(
            {"device": smi, "analysis": an}, indent=1, default=str))
        print(json.dumps({"analysis": analysis_summary(an)}, default=str))
        print(smi)
        return
    if only == "long":
        lg = long_phase(dev)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_long.json").write_text(json.dumps(
            {"device": smi, "long": lg}, indent=1, default=str))
        print(json.dumps({"long": long_summary(lg)}, default=str))
        print(smi)
        return
    if only == "examples":
        ex = examples_phase(dev)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_examples.json").write_text(json.dumps(
            {"device": smi, "examples": ex}, indent=1, default=str))
        print(json.dumps({"examples": examples_summary(ex)}, default=str))
        print(smi)
        return
    if only == "matmul":
        mm = check_matmul(dev)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_matmul.json").write_text(json.dumps(
            {"device": smi, "matmul": mm}, indent=1, default=str))
        print(json.dumps({"matmul": {k: {f: v[f] for f in (
            "ms", "device_ms", "library_ms", "library_device_ms",
            "bound_ms", "launches", "max_abs_err", "prefill_float32",
            "prefill_bfloat16")} for k, v in mm.items()}}))
        print(smi)
        return

    marks = [("start", time.perf_counter())]

    def mark(phase: str) -> None:
        """The phase's seconds (the card is freed after it)."""
        gc.collect()
        torch.cuda.empty_cache()
        marks.append((phase, time.perf_counter()))

    t0 = time.perf_counter()
    trace = make_trace(N_PACKETS, N_FLOWS, seed=0)
    log(f"trace    : {trace.size} packets over {N_FLOWS} flows in "
        f"{time.perf_counter() - t0:.1f} s (numpy seed 0)")

    res = check_codec(dev)
    res.update(check_unpacked_codec(dev))
    res.update(check_attention(dev))
    res.update(check_counter(dev, trace))
    res.update(check_matmul(dev))
    check_small(dev)
    mark("3-4 kernels, small")
    # B7/B8 have no model caller: their launches are check_matmul's drive
    # pass over the projection shapes
    launches: dict[str, int] = {k: res[k]["launches"] for k in (
        "dequant_matmul", "dequant_matmul_packed")}
    serve_res = serve(dev, launches)
    mark("5-6 serve")
    sketch_res = sketch_phase(dev, trace, launches)
    assert sketch_res["obs"]["launches"] > 0, "obs sync never launched B9"
    del trace
    mark("7 sketch")    # the serving model and the sketch are gone
    train_res = train_phase(dev, launches)
    gc.collect()
    torch.cuda.empty_cache()
    train_res["resume"] = train_resume_phase(dev)
    # B5's codes mode and B6 on the train path: the checkpoint's F2P16
    # snapshot (save) and restore of phase 8(b)
    launches["quantize"] = train_res["resume"]["save_launches"]["quantize"]
    launches["dequantize"] = train_res["resume"]["restore_launches"][
        "dequantize"]
    mark("8 train")
    fl_res = fl_phase(dev)
    mark("9 fl")
    fam_res = families_phase(dev)
    mark("10 families")
    rec_res = recurrent_phase(dev)
    mark("11 recurrent")
    fr_res = frontends_phase(dev)
    mark("12 frontends")
    mt_res = moe_train_phase(dev)
    mark("13 moe_train")
    ex_res = examples_phase(dev)
    mark("14 examples")
    # 15(b) is held to phase 11(d)'s xLSTM losses (the same arch, configs,
    # data and steps), as 15(c) to phase 8's: no (1,1) CLI run again
    sh_res = sharded_phase(
        dev, plain_losses=train_res["losses"][:SHARD_LLAMA_STEPS],
        plain_gnorms=train_res["grad_norms"][:SHARD_LLAMA_STEPS],
        xlstm_losses=rec_res["train"]["losses"],
        scout_run=(mt_res["scout"]["losses"][:SHARD_TP_STEPS],
                   mt_res["scout"]["grad_norms"][:SHARD_TP_STEPS]))
    mark("15 sharded")
    an_res = analysis_phase(dev)
    mark("16 analysis")
    long_res = long_phase(dev)
    mark("17 long")
    phase_s = {m: round(t - marks[i][1], 1)
               for i, (m, t) in enumerate(marks[1:])}
    log(f"phases   : seconds {phase_s}, "
        f"{marks[-1][1] - marks[0][1]:.1f} in all")

    kernels = []
    for name in ("attention_paged", "attention_packed", "quantize_packed",
                 "dequantize_packed", "quantize", "ef_roundtrip",
                 "dequantize", "counter_advance", "counter_estimate",
                 "dequant_matmul", "dequant_matmul_packed"):
        assert launches[name] > 0, f"kernel {name} never launched"
        r = res[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SRC,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r.get("bound_by", "bytes"),
            "library_ms": r["library_ms"]})
        if name in ("quantize_packed", "dequantize_packed"):
            kernels[-1]["launches_by_mode"] = launches[name + "_modes"]
        if name in fl_res["launches"]:
            # the FL path's launches (phase 9: fed-avg and fleet rounds)
            assert fl_res["launches"][name] > 0, f"FL never launched {name}"
            kernels[-1]["fl_launches"] = fl_res["launches"][name]
        if name in fam_res["launches"]:
            # phase 10's main path: scout's paged, copy-in and unfused runs
            assert fam_res["launches"][name] > 0, \
                f"phase 10 never launched {name}"
            kernels[-1]["families_launches"] = fam_res["launches"][name]
        if name in rec_res["launches"]:
            # phase 11's main path: xLSTM and jamba served, xLSTM trained
            kernels[-1]["recurrent_launches"] = rec_res["launches"][name]
        if name in fr_res["launches"]:
            # phase 12's main path: whisper and internvl2 decoded, served
            kernels[-1]["frontends_launches"] = fr_res["launches"][name]
        if name in mt_res["launches"]:
            # phase 13's main path: scout and the MoE smoke configs trained,
            # the smoke configs' checkpoints saved (B5) and restored (B6)
            assert mt_res["launches"][name] > 0, \
                f"phase 13 never launched {name}"
            kernels[-1]["moe_train_launches"] = mt_res["launches"][name]
        # phase 14's main path: the example twins (B7/B8: none calls them)
        kernels[-1]["examples_launches"] = ex_res["launches"][name]
        if name in sh_res["launches"]:
            # phase 15's: the sharded part's ranks, on shards
            kernels[-1]["sharded_launches"] = sh_res["launches"][name]
        long_name = "kv_write" if name == "quantize_packed" else name
        if long_name in long_res["launches"]:
            # phase 17's main path: the long-context engines and decodes
            kernels[-1]["long_launches"] = long_res["launches"][long_name]
        log(f"kernel   : {name:18s} {r['ms']:.5f} ms (bound "
            f"{r['bound_ms']:.5f}, plain {r['plain_ms']:.5f}, library "
            f"{r['library_ms']}) launches {launches[name]} | {r['shape']}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": smi, "kernels": kernels, "serve": serve_res,
         "sketch": sketch_res, "train": train_res, "fl": fl_res,
         "families": fam_res, "recurrent": rec_res, "frontends": fr_res,
         "moe_train": mt_res, "examples": ex_res, "sharded": sh_res,
         "analysis": an_res, "long": long_res, "phase_seconds": phase_s,
         "shapes": {k: v["shape"] for k, v in res.items()},
         "unpacked_per_shape": res["quantize"]["per_shape"],
         "ef_roundtrip_row": res["ef_roundtrip"],
         "attention_rows": {k: res[k] for k in ("attention_paged",
                                                "attention_packed")},
         "kv_write_rows": res["quantize_packed"],
         "dequantize_rows": res["dequantize_packed"],
         "matmul_rows": res["dequant_matmul"]["rows"]}, indent=1,
        default=str))
    print(json.dumps({"sketch": sketch_res}))
    print(json.dumps({"train": {k: v for k, v in train_res.items()
                                if k != "profile"}}))
    print(json.dumps({"fl": fl_summary(fl_res)}))
    print(json.dumps({"families": families_summary(fam_res)}, default=str))
    print(json.dumps({"recurrent": recurrent_summary(rec_res)}, default=str))
    print(json.dumps({"frontends": frontends_summary(fr_res)}, default=str))
    print(json.dumps({"moe_train": moe_train_summary(mt_res)}, default=str))
    print(json.dumps({"examples": examples_summary(ex_res)}, default=str))
    print(json.dumps({"sharded": sharded_summary(sh_res)}, default=str))
    print(json.dumps({"analysis": analysis_summary(an_res)}, default=str))
    print(json.dumps({"long": long_summary(long_res)}, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
