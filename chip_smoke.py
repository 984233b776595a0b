#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (turbo_metrics_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from turbo_metrics_tpu_torch/csrc with nvcc;
     the Python counts of 32x8 partial tiles that size the SSIMULACRA2,
     SSIM, VIF and ADM level scratch equal to the library's
     (tm_level_blocks, tm_ssim_blocks, tm_vif_blocks, tm_adm_blocks) on
     sizes that cross tile edges and on every level of the 1080p (and 4K)
     pyramids; the registers, shared memory, blocks per SM and spills of
     every fused level kernel instance (adm_tile_kernel among them), of the
     motion kernel (#16, #17) per luma type, of #4's fused_tail_kernel, of
     the conversion kernel (#5, #6; tm_convert_attributes) and of the XPSNR
     kernel (#13; tm_xpsnr_attributes) per type pair, and of every instance
     of the fixed-point kernels K-int-VIF (narrow and wide) and K-int-ADM
     (with and without their check stores; their partial counts
     tm_integer_vif_blocks and tm_integer_adm_blocks checked like VIF's and
     ADM's); the SASS instructions and MUFU of #5's and #6's BT.709
     instances (tools/sass_count.py), which set their instruction bounds,
     the IMAD, IADD3, LDS and FFMA of K-int-VIF's and K-int-ADM's u8
     instances per thread and per output pixel (INT_SASS); #19's
     blur_probe_kernel: registers, shared memory, blocks per SM and spills
     (tm_blur_probe_attrs), its FFMA and LDS per output of one repetition
     (at least 22 FFMA);
  3. write a seeded 1080p 8-bit 4:2:0 BT.709 limited-range Y4M pair
     (16 frames, noise on a smooth base) to a temporary directory;
  4. score it through the port's CLI (-m ssimulacra2 --output json), every
     launch counter reset just before and read just after: 16 finite
     scores, kernels 1 and 2 launched;
  4a. score it through the multi-metric route (-m ssimulacra2 -m psnr -m ssim
     -m msssim), counters reset just before and read just after: 16 finite
     values of each metric, kernels #6, #3, #11, #12 and 2 launched,
     SSIMULACRA2 within 1e-3 of phase 4's scores;
  4b. score the same pair with XPSNR, (a) alone (-m xpsnr) and (b) beside the
     four RGB families, counters reset just before and read just after each
     run: 16 finite XPSNR values, kernel #13 launched once per batch, the
     XPSNR of (a) and (b) equal, the RGB families of (b) as in phase 4a;
  4c. write a seeded 16-frame 1080p pair of a 10-bit 4:2:2 BT.709
     limited-range reference and an 8-bit 4:2:0 distorted stream, and score
     it (c) with all five metrics: kernel #5 launched at least once per batch
     (the 4:2:2 slot), #6 for the 4:2:0 slot, #13, 16 finite values of each;
  4d. score the 1080p pair of phase 3 with VMAF alone (-m vmaf), counters
     reset just before and read just after: 16 finite values of each
     elementary feature, frame 0's motion 0.0, kernels #14, #15, #16 and #18
     launched once per batch and #17 once (the stream's first frame); then
     the same run with --vmaf-model on a fixture model written to the
     temporary directory: 16 finite fused scores;
  4d-int. path (d-int): the same pair with -m vmaf --vmaf-integer
     --vmaf-model (fixture), counters reset just before and read just after:
     16 finite values of each feature and fused score, K-int-VIF and
     K-int-ADM launched four times per batch (a scale, a level), #16 once
     per batch, #17 once, #14, #15 and #18 no time; motion equal to path
     (d)'s, vif and adm2 within INT_VS_FLOAT of path (d)'s float features;
  4e. score the pair of phase 4c with all six metrics: the VMAF kernels
     launched, 16 finite values of each, the five other metrics within TOL of
     phase 4c's; every 1080p run of phases 4-4e launches kernel #4 no time;
  4e-int. score the pair of phase 4c with -m vmaf --vmaf-integer: 16 finite
     values of each feature, the integer kernels four times per batch,
     motion equal to path (e)'s;
  4f. write a seeded 8-frame 3840x2160 8-bit 4:2:0 BT.709 limited-range Y4M
     pair and score it with -m ssimulacra2 (B=4 by default_batch), counters
     reset just before and read just after: 8 finite scores, kernel 1 twice,
     #3 four times (levels 1 and 2), #4 twice (levels 3-5), kernel 2 never;
  4g. the compressed-input path (ROADMAP Queue 1 item 4) on the committed
     pair of turbo_metrics_tpu_torch/tools/clips/ (a 16-frame 1080p VP9 MKV
     reference and MPEG-2 TS distorted stream, and clips.json, their record
     made by tests/torch_io_clips.py with the JAX package on the CPU).  First
     an explicit probe, before any decode, prints what the machine has: g++,
     pkg-config's libav, the libav shared objects, the native shim's build
     or load (io/native.py), Pillow and cv2.  With Pillow, the golden pair
     of phase 6 as 8-bit PNG files through the CLI: the golden score within
     0.05, the sRGB conversion pass (fused_scale_srgb) launched and #3 not.
     Where the shim builds or
     loads: the decoded planes of both clips equal the record's sha256;
     -m ssimulacra2 on (MKV, TS), counters reset just before and read just
     after: 16 finite scores, kernels 1 and 2 launched, within 0.01 per
     frame of the record's JAX scores; the same with --decode-workers 2 and
     on Y4M files of the decoded frames: bit-equal.  Where it does not:
     NativeVideoSource raises the port's error naming the missing libav
     libraries, a line says that compressed decoding through the shim was
     not checked; then, with cv2, create_source takes the JAX package's
     fallback (OpenCvVideoSource, 8-bit RGB): the CLI on (MKV, TS): 16
     finite scores, the sRGB conversion pass and kernel 2 launched, #3 not,
     --decode-workers 2 (ignored)
     and compute_frames on the decoded frames bit-equal, within 0.01 of the
     plain five-blur chain on the card and, where the card's cv2 decodes the
     record's RGB frames, of the record's JAX scores of those frames;
     without cv2, create_source raises an error naming the stream.  Decode
     ms per frame of each codec; phase 7 times the compressed pair's CLI
     warm beside a Y4M pair's;
  5. hold each kernel against its plain PyTorch twin on the card at the main
     path's shapes (batch 8): sub-scores rtol 1e-4 / atol 1e-5, the emitted
     level 1 atol 1e-5, frame scores within 0.01 (also against the CLI's),
     and the same sub-scores from a second run; then the kernel path at
     other depths, transfers and ranges on small odd-sized pairs;
  5a. the same for the multi-metric kernels: conversion atol 1e-6, kernel #3
     as kernel 2 and its sums equal bit for bit to #4's on the same level
     run as one level, SSIM sums rtol 1e-5 with the emitted level 1 exactly equal,
     the MS-SSIM tail rtol 1e-5; the same for #11 (quantize, emit) on
     11x11, 42x43 and 67x99 and #12 from 67x99, sizes that cross the 32x32
     tiles' edges; per frame, the kernel route against the
     plain route and the CLI: PSNR 1e-4 dB, SSIM and MS-SSIM 1e-5,
     SSIMULACRA2 0.01; then a small odd-sized pair with an 8-bit reference
     and a 10-bit distorted stream, engine on the card against engine on
     the CPU;
  5b. kernel #13 against its twin, all three grids equal, on both 1080p
     batches (frame 8 takes its previous frame across the batch boundary),
     the XPSNR from the twin's grids within 1e-9 of the CLI's; #13 on small
     odd sizes at 10 and 16 bits (wrapping SSE), with a shifted distorted
     stream and int32 luma codes; kernel #5 against its twin at 1080p 4:2:2
     10-bit B=8 (atol 1e-6) and on 67x99 at 4:2:0, 4:2:2 and 4:4:4 for
     every transfer (atol 1e-6, 1e-4 for PQ); path (c)'s engine on the card
     against the same engine on the CPU on a small odd-sized pair of the
     same formats (PSNR 1e-4, SSIM and MS-SSIM 1e-5, SSIMULACRA2 0.01,
     XPSNR 1e-9, and VMAF's features: motion equal, VIF 1e-5, ADM 1e-4);
  5c. kernels #16 and #17 against their twins, blurred planes and row SADs
     equal, on both 1080p batches (frame 8 takes frame 7's blur across the
     batch boundary), on two seeded B=8 batches of 10-bit u16 luma at
     1080p (path (e)'s) and on small odd sizes at 10 and 16 bits; #14 + #15
     sums rtol 1e-4 / atol 1e-5 per scale, scores 1e-5, also on 13x21 (the
     17-tap window wider than the plane), 67x99 and 35x131; #18 sums rtol
     1e-4, scores 1e-4; the VMAF features of the twins' route against the CLI's;
  5d. kernel #4 against its twin (sums rtol 1e-4 / atol 1e-5) and against
     kernel 2 (bit for bit) on the 4K pair's level 3 (B=4), on a 67x99 pair
     from level 0 (five levels, kernel 2 bit for bit)
     and on the 2560x1440 route (kernel 1, #3, #4 on four levels); the 4K
     kernel step against the twins (sub-scores rtol 1e-4 / atol 1e-5) and
     against the five-blur plain chain and the CLI (scores 0.01);
  5e. Ssimulacra2(1920, 1080, backend=b) for pallas (#8 per level), pallas2
     (#10 per level, #7 between) and pallas3 on the 1080p B=8 pair, counters
     reset around each, against the plain chain (same limits); #7 equal to
     its twin bit for bit (avg_pool2d's largest difference logged); #8 and
     #10 against their twins; the jnp_iir backend on the golden pair;
  5f. kernel #19, the blur-only probe of the dissect tool, against its twin
     at the tool's shape (B=4, 1080p) and on a 67x99 and a 300x700 plane
     (inside one 128x512 region tile and across six): per-plane totals rtol
     1e-5, every other entry exactly 0;
  5g. kernel #18 against its twin (sums rtol 1e-4) on 5x7, 13x21, 67x99 and
     1080p pairs (the mask's halo leaves the band plane on some level of
     the first three); #6 and #5 against their twins on 67x99, 35x131, 9x30
     and 1x1 planes, 8- and 16-bit, at 4:2:0 (#6 too), 4:2:2 and 4:4:4,
     BT.709 and PQ (atol 1e-6, 1e-4 for PQ): the ragged ends of rows and
     the unaligned chunks;
  5h. #16 and #17 against their twins bit for bit at the sizes where the
     motion kernel branches (3x3, 5x17, widths on either side of a 16-byte
     chunk and of a warp's row segment, u8, u16 and int32 luma at 8-16
     bits, u16 and int32 rows of whole aligned chunks: 8, 16, 240 and 480
     u16, 4, 120 and 124 int32 samples), on two batches across the batch
     boundary; #4 against its twin and bit for bit against kernel 2 on the
     4K level 3, the 1440p level 2, 67x99 and odd chains whose levels fall
     below one 32x32 tile;
  5i. #13 against its twin bit for bit at tools/edge_cases.py's
     XPSNR_EDGE_CASES (the branch points of tests/test_torch_xpsnr.py:
     widths 15-17, 31-33 and either side of a warp's row segment, heights
     1 and 15-17, u8, u16 and int32 references, and every pair of types
     that differ in the kernel's instances), on two batches across the
     batch boundary; #5 (4:4:4, 4:2:0) and #6 against their twins at the
     code values on either side of the BT.709 and sRGB thresholds, 0 and
     the range ends, 8, 10 and 16 bits, both ranges, every transfer (atol
     1e-6, 1e-4 for PQ), and #5 (4:2:0, 4:2:2) and #6 on u8 and u16 luma
     views one sample past their storage's start, each on its own log line;
  5j. K-int-VIF and K-int-ADM against their twins (run on the card) at
     1080p B=8, on path (d-int)'s u8 luma and on a seeded 10-bit u16 batch:
     every integer surface equal (VIF's s11, s22, s12, mu1, mu2 per scale
     and each scale's input; ADM's six bands and angle gate per level, from
     the kernels' check stores), VIF's sums per scale within rel 1e-6,
     ADM's within rel 1e-5; the twins' features against the CLI's (d-int);
     the same at INT_EDGE_SIZES (1x1 to 96x128, h < 9, u8, u16 and int32
     at 8 to 16 bits); the engine with vmaf_integer on the card against the
     CPU on a 67x99 10-bit 4:2:2 / 8-bit 4:2:0 pair;
  6. score the frozen golden pair through the kernel route: 80.486135 +- 0.05;
  7. time each kernel and its twin (#7 also against avg_pool2d, #19 against
     five F.conv2d blurs with TF32 off, separable and as one 11x11 kernel,
     and with passes=1 against passes=5: the probe kernel's device time
     at passes=5 at least twice that at passes=1),
     the whole kernel and plain steps of both 1080p routes, of VMAF and of
     the 4K route, with CUDA events after warm-up; the 4K step beside the
     route it replaced (kernel 1, then kernel 2 on levels 1-5) on the same
     inputs, by CUDA events and by torch.profiler device time; #4 and
     kernel 2 on the 4K levels s-5 from each first level s (device and call
     times); #16, #17, #13, #5, #6 and kernel 1's conversion pass by device
     time too; K-int-VIF and K-int-ADM (call and device time) against their
     twins, and the VMAF step with vmaf_integer beside the float one
     (float, integer, integer plain x2, integer, float); the peak
     device memory of one kernel step above its inputs (1080p SSIMULACRA2,
     multi-metric, VMAF float and integer, 4K SSIMULACRA2); and the CLI
     runs of phases 4, 4a, 4b (a), 4c, 4d, 4d-int, 4e, 4f and 4g (the
     compressed pair and a Y4M pair) again warm, three times each in turn;
  8. the dissect path: turbo_metrics_tpu_torch.tools.kernel_dissect at its
     default shape, counters reset just before and read just after: every
     wrapper it times launched (#19, #6, #5 and #13 among them), a device time for
     every CUDA kernel of every entry;
  9. frame data parallelism (parallel/mesh.py): (a) phase 3's pair (16
     frames, B=8) through TurboMetrics.compute_all unsharded and over a mesh
     of two shards of card 0, each on its own stream (a shard edge inside
     each batch, the state across the batch edge), with all six metrics and
     the fixture model, with --vmaf-integer's engine and the model, and with
     SSIMULACRA2 alone, counters reset just before and read just after each
     run: every FrameScores field equal to the unsharded engine's (a field
     that is not is logged with its difference and held to
     tests/test_parallel.py's bars: scores 1e-6, VIF, ADM and XPSNR 1e-9,
     motion exact), each wrapper launched once per shard where the
     unsharded run launched it once, #17 once more per batch (the later
     shard's previous frame); (b) one mesh batch inside device_trace: besides
     the default stream, kernels on two streams, equal launches but the
     edge blur; (c)
     with several cards, (a) over every card, else a line saying that the
     cross-device path went unexercised; (d) dryrun_multichip over the two
     shards; (e) one batch's time unsharded and over the mesh by CUDA events
     (unsharded, mesh, mesh, unsharded), then each way's split into
     uploads, launches with their device work, edge uploads and host
     scoring (host clock) and its kernels' device time (torch.profiler);
  10. width sharding (parallel/mesh.py shard_over_width): (a) a seeded
     7680x4320 B=1 linear-RGB pair through Ssimulacra2(7680, 4320)
     (pallas3) unsharded, then ssimulacra2_subscores over 2, 4 and 8
     column strips of card 0 (8: kernel 2 takes a strip's levels 1-5),
     each strip on its own stream, and the same for a
     seeded 8-bit 4:2:0 pair through ssimulacra2_subscores_from_yuv,
     counters reset just before and read just after each run: sub-scores
     within atol/rtol 2e-5 of the unsharded ones (tests/test_parallel.py's
     bar), the score within 1e-5, each wrapper of each strip's route
     (models/ssimulacra2.level_route of the strip's own width) launched
     once per strip, the gaps logged; (b) kernels 1, 2, #3 and #4 with
     windows of owned columns that cut 32-column tiles mid-way (67x99, the
     4K level 3, an odd 8K strip 4320x2081) against their twins, sums at
     phase 5d's bars (rtol 1e-4 / atol 1e-5); (c) (a) from host copies of
     the inputs against the unsharded run on the card's tensors: one strip
     per card with several cards, else two strips of the one card and a
     line saying that the cross-device path went unexercised; (d) one call of each entry
     unsharded and over 2, 4 and 8 strips by CUDA events (unsharded, 2, 4,
     8, 8, 4, 2, unsharded) with each call's peak device memory (allocated, and
     reserved from an emptied cache), and one 4-strip
     call inside device_trace: the streams and whether #4's grids (each
     sized to the whole card) overlapped; (e) the kernels line's entries of
     kernels 1, 2, #3 and #4 carry (b)'s largest difference
     ("windowed_max_abs_err");
  11. width sharding of PSNR, SSIM, MS-SSIM and XPSNR (shard_over_width of
     ops/quality.quality_from_rgb and ops/kernels/xpsnr.xpsnr_block_stats):
     (a) a seeded 7680x4320 B=1 linear-RGB pair buffer through
     quality_from_rgb (PSNR, SSIM, MS-SSIM at five levels: owned edges on
     multiples of 16, a halo of 80 columns) unsharded, then over 2, 4 and
     8 column strips of card 0, each strip on its own stream, counters
     reset just before and read just after each run: PSNR bit-equal, SSIM
     and MS-SSIM within 1e-6 (tests/test_parallel.py's score bar), #11
     and #12 launched once per strip; (b) a seeded 8K u8 luma pair and a
     10-bit u16 reference against 8-bit luma (dis_shift 2) through #13
     over the same strips (owned edges on multiples of 16, one block of
     halo): every grid and the XPSNR in dB bit-equal, #13 launched once per
     strip; (c) #11 (quantizing and not) and #12 with windows of owned
     columns that cut 32-column tiles mid-way (67x99, a 1080p level, an odd
     8K strip 4320x2081) against their twins at phase 5a's bars (sums rtol
     1e-5, the emitted level equal), and the full window bit-equal to no
     window; (d) (a) and (b) from host copies of the inputs: one strip per
     card with several cards, else two strips of the one card and a line
     saying that the cross-device path went unexercised; (e) one call of
     each entry unsharded and over 2, 4 and 8 strips by CUDA events
     (unsharded, 2, 4, 8, 8, 4, 2, unsharded) with each call's peak device
     memory (allocated, and reserved from an emptied cache); (f) the
     kernels line's entries of #11 and #12 carry (c)'s largest difference
     ("windowed_max_abs_err"), #13's whether the sharded grids were equal
     ("sharded_grids_equal");
  12. width sharding of VMAF's float features (shard_over_width of
     ops/kernels/vif.vif_scale_stats, adm.adm_stats, motion.motion_stats
     and motion.integer_blur): (a) a seeded 7680x4320 B=2 u8 luma pair (its
     f32 pair for VIF and ADM), the u8 reference luma with prev0 the blur
     (#17) of a third seeded frame, and a 10-bit u16 luma with its own
     prev0, each entry unsharded, then over 2, 4 and 8 column strips of
     card 0 (VIF: owned edges on multiples of 8, a halo of 24 columns; ADM
     16 and 32; motion and #17 16 and 16), each strip on its own stream,
     counters reset just before and read just after each run: VIF and ADM
     sums within rtol 1e-6 and vif_scores / adm_score (the frame's size)
     within 1e-6, the blurred planes, row SADs, motion scores and #17's
     planes bit-equal, vif_scale0, vif_tail, adm_stats, motion_stats and
     integer_blur launched once per strip; (b) #14, #15, #16 and #18 with
     windows of owned columns that cut tiles mid-way (67x99, 75x101,
     1080p, an interior and an odd-width edge strip of an 8K frame, #18 as
     a column strip of its frame: block loads and tensor copies) against
     their twins at phase 5c's bars, and the full window bit-equal to no
     window; (c) (a) from host copies of the inputs: one strip per card
     with several cards, else two strips of the one card and a line saying
     that the cross-device path went unexercised; (d) one call of each
     entry unsharded and over 2, 4 and 8 strips by CUDA events (unsharded,
     2, 4, 8, 8, 4, 2, unsharded) with each call's peak device memory; (e)
     the kernels line's entries of #14, #15 and #18 carry (b)'s largest
     difference ("windowed_max_abs_err"), #16's and #17's whether the
     sharded planes and row sums were equal ("sharded_planes_equal");
  13. width sharding of VMAF's fixed-point features (shard_over_width of
     ops/kernels/integer_vif.integer_vif_stats and
     integer_adm.integer_adm_stats, VIF's and ADM's plans) and the plain
     entries on their kernels: (a) a seeded 7680x4320 B=2 pair of u8 codes
     and of 10-bit u16 codes, each entry unsharded, then over 2, 4 and 8
     strips of card 0, each on its own stream: sums within rtol 1e-6,
     vif_scores / adm_score (the frame's size) within 1e-6, each wrapper's
     four launches once per strip; (b) K-int-VIF and K-int-ADM with phase
     12's windows (67x99, 75x101, 1080p, an interior and an odd-width edge
     8K strip; K-int-ADM as a column strip of its frame), u8 and 10-bit
     codes, against their twins at phase 5j's bars (sums rtol 1e-6 and
     1e-5; chunk loads and tensor copies, and the per-sample loads, both
     taken), the full window bit-equal to no window; (c) ops/quality.py
     ssim, msssim (5 levels, clamped to 3 at 67x99, and 3) and ssim_msssim
     with backend "auto" against "jnp" on the same CUDA tensors at 1080p
     B=8 and 67x99 (within 1e-5; #11 and #12 launched by "auto", none by
     "jnp"), ops/xpsnr_ops.py xpsnr_block_stats with a seeded per-frame
     y_prev (#13) bit-equal to "jnp" and, with y_prev[b] = y_ref[b-1], to
     the kernel wrapper's prev0 convention, JAX's gates (one channel, a dim
     under 11, block 8, a y_prev of another type, 4-D planes) taking the
     plain route without a launch; then ssim, msssim, ssim_msssim and the
     plain XPSNR statistics on an 8K B=1 pair over 2, 4 and 8 strips
     (SSIM and MS-SSIM within 1e-6, XPSNR grids and dB bit-equal, one
     launch of each wrapper per strip); (d) (a) and (c)'s sharded calls from
     host copies: one strip per card with several cards, else two strips
     of the one card and a line saying that the cross-device path went
     unexercised; (e) one call of each entry unsharded and over 2, 4 and 8
     strips by CUDA events with its peak device memory, each plain entry's
     kernel route against its "jnp" route at 1080p B=8, and the pair copy
     of the kernel route; (f) the kernels line's entries of K-int-VIF and
     K-int-ADM carry (b)'s largest difference ("windowed_max_abs_err"),
     #13's whether the per-frame previous planes gave the plain route's
     grids ("per_frame_prev_equal");
  14. the plain VMAF-feature and conversion entries on their kernels: (a)
     ops/vif.py vif_scale_stats and ops/adm.py adm_stats (float, and
     integer=True on u8 and 10-bit codes), ops/vmaf_motion.py integer_blur
     and motion_stats (per-frame previous planes, and one plane for every
     frame) and ops/colorspace.py yuv420_to_linear_rgb (8-bit 4:2:0, 10-bit
     4:2:2 PQ) with backend None (the kernels on a CUDA tensor) against
     "jnp" on the same tensors at 1080p B=8 and 67x99, counters reset just
     before and read just after each call: #14 + #15, K-int-VIF (four),
     #18, K-int-ADM (four), #17, #16 and #5 launched by None, none by
     "jnp"; VIF's sums within rtol 1e-4 and its features 1e-5, ADM's 1e-4,
     the fixed-point sums within rtol 1e-6 (VIF) and 1e-5 (ADM), motion and
     the blur bit for bit, the conversion within 1e-6 (PQ 1e-4); JAX's
     gates and the kernels' types (a side of 31, 2-D planes, ADM's windows,
     int64 luma, int32 previous planes, a conversion pair, uint16 at 8
     bits) taking the plain route without a launch; (b) #16 with every
     frame's own previous plane (seeded, none the blur of the frame
     before; and one plane for every frame) bit-equal to its twin and the
     plain route at 1080p B=8 u8 and 10-bit, 67x99 10-bit u16 and int32,
     the previous planes [prev0, blur of frames 0 .. B-2] bit-equal to the
     prev0 convention, and its time beside the prev0 convention's (prev0,
     per frame, per frame, prev0); (c) the plain VIF, ADM, motion_stats
     (per-frame previous planes cut like the luma) and integer_blur on
     phase 12's 8K B=2 u8 luma over 2, 4 and 8 strips of card 0 at phase
     12's bars, each wrapper launched once per strip; (d) each entry's
     kernel route against its "jnp" route at 1080p B=8 by CUDA events, and
     the f32 pair copy of VIF's and ADM's kernel route; (e) the kernels
     line's entry of #16 carries (b)'s times ("per_frame_prev_ms",
     "prev0_ms").
  15. scale 0 straight from packed integer RGB (fused_scale_srgb,
     csrc/ssimulacra2_scale.cu srgb_to_xyb_kernel, no TPU counterpart): (a)
     at 1080p B=8 u8 and 16-bit, 1081x1919 B=8 u8, 1080p B=1 and 67x99 B=3
     10-bit in uint16, the model entry's sub-scores and the wrapper's sums
     and level 1 bit-equal to the plain route on the same codes
     (colorspace.srgb_pair_to_linear, then #3 and the level chain), one
     launch of fused_scale_srgb per call and none of #3; (b) the engine on 8-bit RGB frames (67x99,
     two batches): SSIMULACRA2 alone launches fused_scale_srgb once a batch
     and no #3, and scores bit-equal to the engine with PSNR beside it (the
     pair-buffer route); (c) at 1080p B=8 (u8, 16-bit): the wrapper's and
     the plain route's (cast, srgb_to_linear, slot copies, #3) CUDA-event
     ms, their device ms, the conversion pass's device ms against the plain
     conversion's (every kernel but #3's level pass), the whole SSIMULACRA2
     step both ways in turns and its peak memory; (d) the kernels line's
     row "fused_scale_srgb" ("tpu_kernel": false; (a) and (b)'s launches
     and largest difference; the whole wrapper's bound, and the conversion
     pass's under "conversion_bound_ms").
Prints the card, the dissect tool's JSON line, then one JSON line of
per-kernel results (with each
kernel's bound: the larger of its bytes over 3.35 TB/s and its operations
over the peak of their type, the H100 SXM data sheet's 67 TFLOP/s for f32
and, for the integer work of XPSNR and of VMAF's motion, 33.5 TOP/s of
int32: 64 of the SM's 128 lanes take int32, Hopper architecture white
paper; for the conversions #5 and #6, the SASS
instructions of their kernels at 128 lanes per SM and clock, or their MUFU
at 16, whichever takes longer, at the card's highest SM clock; for K-int-VIF
and K-int-ADM, which replace no TPU kernel ("tpu_kernel": false; "replaces"
names the JAX package's jnp function), their int32 operations at the int32
rate or all their operations at the f32 rate), then as the last
line {"ok": true, "device": {...}}.  Without CUDA, or outside the
repository, it exits non-zero and prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

BATCH = 8
FRAMES = 16
WIDTH, HEIGHT = 1920, 1080
# Path (f): UHD encodes, B=4 by the engine's default_batch.
UHD_WIDTH, UHD_HEIGHT, UHD_FRAMES, UHD_BATCH = 3840, 2160, 8, 4
GOLDEN = 80.486135
CSRC = "turbo_metrics_tpu_torch/csrc/"
PALLAS = "turbo_metrics_tpu/ops/pallas/"
MULTI = ("ssimulacra2", "psnr", "ssim", "msssim")
ALL5 = MULTI + ("xpsnr",)
ALL6 = ALL5 + ("vmaf",)
VIF = ("vmaf_vif",) + tuple(f"vmaf_vif_scale{k}" for k in range(4))
ADM = ("vmaf_adm",) + tuple(f"vmaf_adm_scale{k}" for k in range(4))
VMAF_FEATURES = ("vmaf_motion",) + VIF + ADM
TOL = {"psnr": 1e-4, "ssim": 1e-5, "msssim": 1e-5, "ssimulacra2": 0.01, "xpsnr": 1e-9,
       "vmaf_motion": 0.0, **{k: 1e-5 for k in VIF}, **{k: 1e-4 for k in ADM}}
VMAF_KERNELS = ("motion_stats", "integer_blur", "vif_scale0", "vif_tail", "adm_stats")
# VMAF's fixed-point features (path d-int): kernels with no TPU counterpart
# (the JAX package computes them with jnp only), one launch per scale/level.
INT_KERNELS = ("integer_vif_stats", "integer_adm_stats")
# Path (d-int)'s sanity bars against path (d)'s float features: the same
# metric at other arithmetic.  tests/test_integer_paths.py:88-97, 163-176
# hold a 96x128 sinusoid to 5e-3 (vif) and 2e-2 (adm2).  On this script's
# 1080p pair the JAX package's own fixed-point schedule (its means kept in
# Q4) is 0.00971 (vif) and 0.01341 (adm2) from its float features on frames
# 0-1 (tools/vmaf_int_gap.py, on the CPU), so vif is held to that gap plus
# 0.0023 of margin for the other frames, adm2 to 2e-2.  The kernels are held
# to the plain versions exactly (phase 5j).
INT_VS_FLOAT = {"vmaf_vif": 1.2e-2, "vmaf_adm": 2e-2}
# Sizes where the integer kernels branch (phase 5j), as (h, w, depth, luma
# type): the smallest planes, h < 9 (the 17-tap window wider than the plane
# at scale 0), odd sizes that cross the 32x32 tiles' edges, ADM's edge sizes,
# and each luma type; at 96x128 rows of whole 16-byte chunks with interior
# tiles, so that VIF's chunk loads and ADM's tensor copies run at u8 (codes
# pre-rounded from 10 bits) and int32.  u8 codes lie below 2^8 at any depth.
INT_EDGE_SIZES = ((1, 1, 8, np.uint8), (3, 3, 8, np.uint8), (5, 7, 8, np.uint8), (8, 13, 10, np.uint16),
                  (13, 21, 8, np.int32), (67, 99, 10, np.uint16), (35, 131, 16, np.uint16),
                  (33, 65, 8, np.int32), (67, 99, 8, np.uint8), (96, 128, 10, np.uint8),
                  (96, 128, 10, np.int32))
# ADM's edge sizes (phases 2 and 5g): the centre region starts at the band
# plane's first row or column on some level of the first three, so the
# mask's halo leaves the plane there.
ADM_EDGE_SIZES = ((5, 7), (13, 21), (67, 99), (HEIGHT, WIDTH))
MS_LEVELS = 5
# H100 SXM data-sheet peaks: device memory, and f32 outside the tensor cores;
# int32 at half the f32 rate (64 of the SM's 128 lanes, Hopper white paper).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_I32_PER_S = 33.5e12
# f32 operations per pixel (an FMA counts 2, a pow, cube root or rounding 1);
# #5 and #6, whose work is the conversion alone, are counted in the SASS
# instructions of their kernels instead (CONVERSION_SASS).
# One image's BT.709 conversion: luma 3; per channel the chroma term 1, the
# power segment's argument 3, lg2, the scale and ex2 3, the threshold's
# select 1 and the clamp 2 (each channel counted on the power segment, as
# most of the data falls there); the chroma terms, 6 per 2x2 quad, 1.5.
# Its MUFU (lg2 and ex2, 6 per pixel) at 16 lanes per SM and clock take less
# time than its f32 work at 128.
F_CONVERT = 34.5
F_XYB = 59  # one image: opsin mix 24, three refined cube roots 21, XYB 10, 2x2 mean 4
F_S2 = 205  # per channel of the pair: products 3, two 11-tap passes over 4 planes 176, maps 26
F_QUANT = 8  # per channel of the pair: x*255, round, two clamps, both images
F_SSIM_ROW = 92  # per channel of the pair: a^2+b^2 and a*b 4, 11 taps over 4 planes 88
F_SSIM_COL = 104  # per valid pixel and channel: 11 taps over 4 planes 88, the map 16
F_HALFPOOL = 8  # per emitted pixel and channel: 3 adds and a scale, both images
# int32 operations per XPSNR pixel: highpass 12 (9 taps as adds, two scales,
# abs), err and err^2 2, |ref - prev| 2, the shift 1, three sums 3.
I_XPSNR = 20
# int32 operations per pixel of VMAF's motion blur: two 5-tap passes of 5
# multiplies and 4 adds, each with its rounding add and shift; the SAD adds
# |blurred - previous| and the row sum (3).
I_BLUR = 22
I_MOTION = I_BLUR + 3
# Per pixel of the pair at one fixed-point VIF scale, the least work with
# the symmetric windows folded (csrc/integer_vif.cu): int32 operations per
# tap pair k < R of the window 30 (five quantities, two passes, an add of
# the pair's samples 1 and a multiply-add of 2), per centre tap 20 (ten
# multiply-adds), 29 per pixel (the products 3, ten rounding adds and shifts
# 20, the moments 6), per tap pair of the next window 4.5 and its centre 3
# (ref and dis: the vertical pass at half the pixels, the horizontal at a
# quarter) and 3 of its rounding; f32 25 (the guarded map with two log2).
# The bound of the unfolded windows counts 20 per tap of the window (2R +
# 1) and 3 per tap of the next one (I_IVIF_TAP_UNFOLDED).
I_IVIF_PAIR = 30
I_IVIF_CENTRE = 20
I_IVIF_TAP_UNFOLDED = 20
I_IVIF_PIX = 29
I_IVIF_EMIT_PAIR = 4.5
I_IVIF_EMIT_CENTRE = 3
I_IVIF_EMIT_TAP_UNFOLDED = 3
I_IVIF_EMIT = 3
F_IVIF_MAP = 25
# Per input pixel of the pair at one fixed-point ADM level: int32 44 (the
# row pass 16 and its rounding 4, the column pass 16 and its rounding 4, the
# gate at a quarter of the pixels 4), 4 more at level 0 (the pre-rounding and
# (x - 128) << 8); f32 23 (the gate's products, the dequantisation, the
# decoupling, the masks and cubes, at a quarter of the pixels).
I_IADM_LEVEL = 44
I_IADM_CODES = 4
F_IADM_LEVEL = 23
# f32 operations per pixel of the pair at one VIF scale: ref^2, dis^2,
# ref*dis 3 and the guarded map with two log2 ~25, plus per tap of the
# window 20 (five quantities, two passes, a multiply and an add) and per
# tap of the next window 3 (ref and dis: the row pass at half the columns,
# the column pass at a quarter of the pixels).
F_VIF_MAP = 28
F_VIF_TAP = 20
F_VIF_EMIT_TAP = 3
# f32 operations per input pixel of the pair at one ADM level: the row pass
# 16 (lo and hi, 4 taps, both images, at half the columns), the column pass
# 16 (A, H, V, D, 4 taps, both images, at a quarter of the pixels), the
# angle gate and decoupling ~12 and the 3x3 masks and cubes ~19 (both at a
# quarter of the pixels).
F_ADM_LEVEL = 63
# f32 operations per summed pixel of the blur-only probe (#19): 5 repetitions
# x 2 directions x 11 multiply-adds of 2 operations.
F_PROBE = 220
# The SASS of #5's and #6's main-path instances (csrc/convert.cu; transfer
# code 0 is BT.709), counted by tools/sass_count.py: (kernel, pixels per
# thread); a thread of #5 (4:2:2) converts 1x2 pixels, of #6 (4:2:0) 2x2.
CONVERSION_SASS = {
    "yuv_to_linear_rgb": ("yuv_to_rgb_kernel<unsigned short, 1, 2, 0>", 2),
    "yuv420_to_linear_rgb_pair": ("yuv_to_rgb_kernel<unsigned char, 2, 2, 0>", 4),
}
# The kernels redesigned after their first port, and how.
REDESIGNED = {"fused_scale0_yuv": "fused level pass", "fused_scale_rgb": "fused level pass",
              "ssim_sums": "fused tile pass", "vif_scale0": "fused tile pass", "adm_stats": "fused tile pass",
              "motion_stats": "register-window blur, frames walked in order",
              "integer_blur": "register-window blur, frames walked in order",
              "fused_tail": "fused tile passes in one cooperative launch",
              "yuv_to_linear_rgb": "transfer function as a template parameter, MUFU powers, float2 stores",
              "yuv420_to_linear_rgb_pair": "transfer function as a template parameter, MUFU powers, float2 stores",
              "xpsnr_block_stats": "16-byte row chunks in a register window, neighbours by shuffles, dp4a at u8",
              "integer_vif_stats": "folded symmetric taps as kernel parameters, 16-byte tile loads issued first, "
                                   "uint16 shared planes for uint8 codes",
              "integer_adm_stats": "persistent blocks, TMA copies of the next tile at the input's type, "
                                   "one |csf*a| plane",
              "blur_only": "register-blocked row walks on conflict-free 16-byte loads, 64x64 tiles, cp.async fill"}
# The SASS of K-int-VIF's scale-0 and K-int-ADM's level-0 main-path
# instances (uint8 codes), counted by tools/sass_count.py: (kernel, output
# pixels per thread on the common path).  A thread of the VIF instance
# writes eight pixels of its tile; one of the ADM instance four band pixels
# of a tile, each from four input pixels, plus the halo ring.
INT_SASS = {
    "integer_vif_stats": ("integer_vif_kernel<unsigned char, 8, 4, 1, 0>", 8),
    "integer_adm_stats": ("integer_adm_kernel<unsigned char, 1, 0>", 4),
}
# The wrappers the dissect path times (phase 8), each launched there.
DISSECT_KERNELS = ("fused_scale_rgb", "scale_sums", "blur_only", "fused_scale0_yuv", "fused_pyramid_tail",
                   "fused_scale_pair", "ssim_sums", "msssim_tail", "vif_scale0", "vif_tail", "adm_stats",
                   "yuv420_to_linear_rgb_pair", "yuv_to_linear_rgb", "xpsnr_block_stats", "integer_vif_stats",
                   "integer_adm_stats")


def vif_flops(bsz: int, h: int, w: int, scales) -> float:
    """f32 operations of VIF scales ``scales`` from an h x w scale 0."""
    total = 0.0
    for k in range(4):
        if k in scales:
            taps, emit = (1 << (4 - k)) + 1, (1 << (3 - k)) + 1 if k < 3 else 0
            total += bsz * h * w * (F_VIF_MAP + F_VIF_TAP * taps + F_VIF_EMIT_TAP * emit)
        h, w = (h + 1) // 2, (w + 1) // 2
    return total


def integer_vif_ops(bsz: int, h: int, w: int, folded: bool = True) -> tuple[float, float]:
    """(int32, f32) operations of the four fixed-point VIF scales, with the
    windows folded (or, for the bound of the unfolded windows, not)."""
    i_ops = f_ops = 0.0
    for k in range(4):
        r, re = 1 << (3 - k), (1 << (2 - k)) if k < 3 else 0
        px = bsz * h * w
        if folded:
            taps = I_IVIF_PAIR * r + I_IVIF_CENTRE
            emit = I_IVIF_EMIT_PAIR * re + I_IVIF_EMIT_CENTRE + I_IVIF_EMIT if k < 3 else 0
        else:
            taps = I_IVIF_TAP_UNFOLDED * (2 * r + 1)
            emit = I_IVIF_EMIT_TAP_UNFOLDED * (2 * re + 1) + I_IVIF_EMIT if k < 3 else 0
        i_ops += px * (taps + I_IVIF_PIX + emit)
        f_ops += px * F_IVIF_MAP
        h, w = (h + 1) // 2, (w + 1) // 2
    return i_ops, f_ops


def integer_adm_ops(bsz: int, h: int, w: int) -> tuple[float, float]:
    """(int32, f32) operations of the four fixed-point ADM levels."""
    i_ops, f_ops = bsz * h * w * I_IADM_CODES, 0.0
    for _ in range(4):
        i_ops += bsz * h * w * I_IADM_LEVEL
        f_ops += bsz * h * w * F_IADM_LEVEL
        h, w = (h + 1) // 2, (w + 1) // 2
    return i_ops, f_ops


def mixed_ops_ms(i_ops: float, f_ops: float) -> float:
    """Least ms of int32 and f32 operations that share the SMs' issue: the
    int32 ones at their half rate, or all of them at the f32 rate, whichever
    takes longer."""
    return max(i_ops / PEAK_I32_PER_S, (i_ops + f_ops) / PEAK_F32_PER_S) * 1e3


def adm_flops(bsz: int, h: int, w: int) -> float:
    total = 0.0
    for _ in range(4):
        total += bsz * h * w * F_ADM_LEVEL
        h, w = (h + 1) // 2, (w + 1) // 2
    return total


# A hand-built VMAF fusion model (the fixture of tests/test_vmaf_model.py):
# no libvmaf model file is in the repository.
FIXTURE_MODEL = {"model_dict": {
    "model_type": "LIBSVMNUSVR",
    "feature_names": ["VMAF_feature_adm2_score", "VMAF_feature_motion2_score"]
    + [f"VMAF_feature_vif_scale{k}_score" for k in range(4)],
    "norm_type": "linear_rescale",
    "slopes": [0.01, 1.0, 0.5, 1.0, 1.0, 1.0, 1.0],
    "intercepts": [-0.1, 0.0, 0.05, 0.0, 0.0, 0.0, 0.0],
    # Wider than libvmaf's [0, 100], so that the fixture's scores are not all
    # clipped to one value.
    "score_clip": [0.0, 1000.0],
    "model": "svm_type nu_svr\nkernel_type rbf\ngamma 0.05\nnr_class 2\ntotal_sv 2\n"
    "rho -1.25\nSV\n0.75 1:0.9 2:0.1 3:0.8 4:0.85 5:0.9 6:0.95\n"
    "-0.25 1:0.4 2:0.6 3:0.3 4:0.35 5:0.4 6:0.45\n",
}}


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def write_y4m_pair(directory: str, width: int = WIDTH, height: int = HEIGHT,
                   frames: int = FRAMES, tag: str = ""):
    """Seeded 4:2:0 frames: a smooth moving base plus noise as the reference,
    the reference plus more noise as the distorted stream."""
    rng = np.random.default_rng(20261016)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    cy, cx = yy[::2, ::2] / 2, xx[::2, ::2] / 2
    paths = [os.path.join(directory, n) for n in (f"ref{tag}.y4m", f"dis{tag}.y4m")]
    files = [open(p, "wb") for p in paths]
    try:
        for f in files:
            f.write(f"YUV4MPEG2 W{width} H{height} F25:1 Ip A1:1 C420\n".encode())
        for i in range(frames):
            y = 126 + 80 * np.sin(xx / 37.0 + i * 0.1) * np.cos(yy / 23.0)
            u = 128 + 40 * np.sin(cx / 29.0 + i * 0.05)
            v = 128 + 40 * np.cos(cy / 17.0)
            ref = [p + rng.integers(-3, 4, p.shape) for p in (y, u, v)]
            dis = [p + rng.integers(-5, 6, p.shape) for p in ref]
            for f, planes in zip(files, (ref, dis)):
                f.write(b"FRAME\n")
                for p in planes:
                    f.write(np.clip(np.round(p), 0, 255).astype(np.uint8).tobytes())
    finally:
        for f in files:
            f.close()
    return paths


def write_mezzanine_pair(directory: str):
    """Seeded frames of path (c): a 10-bit 4:2:2 reference (a smooth moving
    base plus noise) and an 8-bit 4:2:0 distorted stream (the reference
    shifted to 8 bits, every other chroma row, plus noise)."""
    rng = np.random.default_rng(20261017)
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float32)
    cy, cx = yy[:, ::2], xx[:, ::2] / 2
    paths = [os.path.join(directory, n) for n in ("ref422p10.y4m", "dis420.y4m")]
    files = [open(p, "wb") for p in paths]
    try:
        files[0].write(f"YUV4MPEG2 W{WIDTH} H{HEIGHT} F25:1 Ip A1:1 C422p10\n".encode())
        files[1].write(f"YUV4MPEG2 W{WIDTH} H{HEIGHT} F25:1 Ip A1:1 C420\n".encode())
        for i in range(FRAMES):
            y = 504 + 320 * np.sin(xx / 37.0 + i * 0.1) * np.cos(yy / 23.0)
            u = 512 + 160 * np.sin(cx / 29.0 + i * 0.05)
            v = 512 + 160 * np.cos(cy / 17.0)
            ref = [np.clip(np.round(p + rng.integers(-12, 13, p.shape)), 0, 1023).astype(np.int64)
                   for p in (y, u, v)]
            dis = [np.clip(p // 4 + rng.integers(-5, 6, p.shape), 0, 255)
                   for p in (ref[0], ref[1][::2], ref[2][::2])]
            for f, planes, dt in ((files[0], ref, np.uint16), (files[1], dis, np.uint8)):
                f.write(b"FRAME\n")
                for p in planes:
                    f.write(p.astype(dt).tobytes())
    finally:
        for f in files:
            f.close()
    return paths


def srgb8_to_linear(img):
    """u8 sRGB -> linear f32 via the 256-entry LUT of the reference."""
    v = np.arange(256, dtype=np.float64) / 255.0
    alpha, beta = 1.0550107, 0.0030412825
    lut = np.where(v < 12.92 * beta, v / 12.92, ((v + (alpha - 1.0)) / alpha) ** 2.4)
    return lut.astype(np.float32)[img]


def golden_pair():
    """The golden pair as linear f32 RGB."""
    return tuple(srgb8_to_linear(img) for img in golden_pair_u8())


def golden_pair_u8():
    """The golden pair's 8-bit sRGB images (120x160x3)."""
    rng = np.random.default_rng(20240901)
    h, w = 120, 160
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [
            128 + 90 * np.sin(xx / 13.0) * np.cos(yy / 11.0),
            128 + 70 * np.cos(xx / 7.0),
            128 + 50 * np.sin((xx + yy) / 19.0),
        ],
        axis=-1,
    )
    ref8 = np.clip(base, 0, 255).astype(np.uint8)
    dis8 = np.clip(ref8.astype(np.int16) + rng.integers(-9, 10, ref8.shape), 0, 255).astype(np.uint8)
    return ref8, dis8


def device_ms(fn, names=None, iters: int = 20) -> float:
    """Device ms per call of fn's CUDA kernels whose base names are in
    ``names`` (every kernel and memset where None; memsets where ``names``
    holds the dissect tool's ``MEMSET``), by the dissect tool's per-launch
    torch.profiler reading: the kernels alone, without the wrapper's host
    time or the gaps between launches."""
    from turbo_metrics_tpu_torch.tools.kernel_dissect import MEMSET, base_name, kernel_device_ms

    seq = kernel_device_ms(fn, iters, memsets=names is None or MEMSET in names)
    hits = [t for n, t in seq if names is None or base_name(n) in names]
    need(bool(hits), f"the profiler recorded none of the kernels {names}")
    return sum(hits)


def counted_kernels() -> dict:
    """Every kernel wrapper, by name: each counts its own launches."""
    from turbo_metrics_tpu_torch.ops.kernels import (
        adm,
        blur_probe,
        convert,
        downscale,
        fused_tail,
        integer_adm,
        integer_vif,
        motion,
        scale_stats,
        scale_tail,
        vif,
        windowed,
        windowed_tail,
        xpsnr,
    )

    return {
        "fused_scale0_yuv": scale_stats.fused_scale0_yuv,
        "fused_pyramid_tail": scale_tail.fused_pyramid_tail,
        "fused_scale_rgb": scale_stats.fused_scale_rgb,
        "fused_scale_srgb": scale_stats.fused_scale_srgb,
        "yuv420_to_linear_rgb_pair": convert.yuv420_to_linear_rgb_pair,
        "ssim_sums": windowed.ssim_sums,
        "msssim_tail": windowed_tail.msssim_tail,
        "yuv_to_linear_rgb": convert.yuv_to_linear_rgb,
        "xpsnr_block_stats": xpsnr.xpsnr_block_stats,
        "motion_stats": motion.motion_stats,
        "integer_blur": motion.integer_blur,
        "vif_scale0": vif.vif_scale0,
        "vif_tail": vif.vif_tail,
        "adm_stats": adm.adm_stats,
        "fused_tail": fused_tail.fused_tail,
        "downscale_by_2": downscale.downscale_by_2,
        "scale_sums": scale_stats.scale_sums,
        "fused_scale_pair": scale_stats.fused_scale_pair,
        "blur_only": blur_probe.blur_only,
        "integer_vif_stats": integer_vif.integer_vif_stats,
        "integer_adm_stats": integer_adm.integer_adm_stats,
    }


def reset_counts() -> None:
    for fn in counted_kernels().values():
        fn.launches = 0


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in counted_kernels().items()}


def output_keys(metrics) -> tuple:
    """The JSON keys that ``-m`` flags give (vmaf: its elementary features;
    the fused score only with a model)."""
    return tuple(k for m in metrics for k in (VMAF_FEATURES if m == "vmaf" else (m,)))


def run_cli(ref_path: str, dis_path: str, dev, metrics, extra=(), keys=None, frames=FRAMES):
    """The port's CLI on the Y4M pair (--output json), every launch counter
    set to 0 just before and read just after.  A 1080p pair (``frames`` ==
    FRAMES) must launch kernel #4 no time.  Returns (scores of each output
    key, launches, host seconds)."""
    from turbo_metrics_tpu_torch import cli

    reset_counts()
    args = [ref_path, dis_path, "--output", "json", "--no-progress", "--device", str(dev)]
    for m in metrics:
        args += ["-m", m]
    args += list(extra)
    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = cli.main(args)
    launches = read_counts()
    seconds = time.monotonic() - t0
    need(rc == 0, f"CLI ({' '.join(metrics)}) exited {rc}")
    result = json.loads(out.getvalue())
    need(result["frame_count"] == frames, f"CLI did not score {frames} frames")
    if frames == FRAMES:
        need(launches["fused_tail"] == 0, f"a 1080p route launched kernel #4: {launches}")
    scores = {}
    for m in keys or output_keys(metrics):
        vals = result[m]["scores"]
        need(len(vals) == frames and all(math.isfinite(v) for v in vals),
             f"CLI {m}: want {frames} finite values, got {vals}")
        scores[m] = np.asarray(vals, dtype=np.float64)
    return scores, launches, seconds


def run_main_path(ref_path: str, dis_path: str, dev, card: str):
    """Phase 4: SSIMULACRA2 alone through the CLI (kernels 1 and 2)."""
    scores, launches, seconds = run_cli(ref_path, dis_path, dev, ["ssimulacra2"])
    log(f"CLI -m ssimulacra2: {FRAMES} frames in {seconds:.2f} s (first call and decode included), "
        f"launches {launches} [{card}]")
    log(f"CLI scores: {scores['ssimulacra2'].tolist()}")
    need(launches["fused_scale0_yuv"] > 0 and launches["fused_pyramid_tail"] > 0,
         f"a kernel of the SSIMULACRA2 route was not launched: {launches}")
    return scores["ssimulacra2"], launches


def run_multi_path(ref_path: str, dis_path: str, dev, card: str, s2_scores):
    """Phase 4a: the four RGB families through the CLI (kernels #6, #3, #11,
    #12 and 2); SSIMULACRA2 within 1e-3 of the SSIMULACRA2-only route."""
    scores, launches, seconds = run_cli(ref_path, dis_path, dev, MULTI)
    log(f"CLI {' '.join('-m ' + m for m in MULTI)}: {FRAMES} frames in {seconds:.2f} s "
        f"(first call and decode included), launches {launches} [{card}]")
    for m in MULTI:
        log(f"CLI {m}: {scores[m].tolist()}")
    path = ("yuv420_to_linear_rgb_pair", "fused_scale_rgb", "ssim_sums", "msssim_tail",
            "fused_pyramid_tail")
    need(all(launches[k] > 0 for k in path), f"a kernel of the multi-metric route was not launched: {launches}")
    d_s2 = float(np.abs(scores["ssimulacra2"] - s2_scores).max())
    log(f"multi-metric route vs SSIMULACRA2-only route: max |score diff| {d_s2:.3g}")
    need(d_s2 <= 1e-3, f"SSIMULACRA2 of the two routes apart by {d_s2}")
    return scores, launches


def run_xpsnr_paths(ref_path: str, dis_path: str, dev, card: str, multi_scores):
    """Phase 4b: XPSNR (a) alone and (b) beside the four RGB families through
    the CLI; kernel #13 once per batch in each, the XPSNR of the two equal,
    the RGB families of (b) those of phase 4a."""
    per_batch = FRAMES // BATCH
    runs = {}
    for tag, metrics in (("a", ("xpsnr",)), ("b", ALL5)):
        scores, launches, seconds = run_cli(ref_path, dis_path, dev, metrics)
        log(f"CLI ({tag}) {' '.join('-m ' + m for m in metrics)}: {FRAMES} frames in {seconds:.2f} s "
            f"(first call and decode included), launches {launches} [{card}]")
        log(f"CLI ({tag}) xpsnr: {scores['xpsnr'].tolist()}")
        need(launches["xpsnr_block_stats"] == per_batch,
             f"({tag}): xpsnr_block_stats launched {launches['xpsnr_block_stats']} times, want {per_batch}")
        runs[tag] = (scores, launches)
    (sa, _), (sb, lb) = runs["a"], runs["b"]
    need(np.array_equal(sa["xpsnr"], sb["xpsnr"]), "XPSNR of (a) and (b) differ")
    for m in MULTI:
        d = float(np.abs(sb[m] - multi_scores[m]).max())
        need(d <= TOL[m], f"(b) {m} apart from phase 4a's by {d}")
    return sa["xpsnr"], lb


def run_mezzanine_path(ref_path: str, dis_path: str, dev, card: str):
    """Phase 4c: path (c), a 10-bit 4:2:2 reference against an 8-bit 4:2:0
    distorted stream, all five metrics through the CLI."""
    scores, launches, seconds = run_cli(ref_path, dis_path, dev, ALL5)
    log(f"CLI (c) 4:2:2 10-bit vs 4:2:0 8-bit, all five metrics: {FRAMES} frames in {seconds:.2f} s "
        f"(first call and decode included), launches {launches} [{card}]")
    for m in ALL5:
        log(f"CLI (c) {m}: {scores[m].tolist()}")
    per_batch = FRAMES // BATCH
    for name in ("yuv_to_linear_rgb", "yuv420_to_linear_rgb_pair", "xpsnr_block_stats"):
        need(launches[name] >= per_batch, f"(c): {name} launched {launches[name]} times, want >= {per_batch}")
    for name in ("fused_scale_rgb", "fused_pyramid_tail", "ssim_sums", "msssim_tail"):
        need(launches[name] > 0, f"(c): {name} was not launched: {launches}")
    return scores, launches


def run_vmaf_paths(ref_path: str, dis_path: str, dev, card: str, tmp: str):
    """Phase 4d: path (d), VMAF alone through the CLI on the 1080p pair,
    without and with a fusion model (the fixture, written to ``tmp``).
    Returns (the elementary features, the fused scores, the launches of the
    run without a model)."""
    per_batch = FRAMES // BATCH
    scores, launches, seconds = run_cli(ref_path, dis_path, dev, ["vmaf"])
    log(f"CLI (d) -m vmaf: {FRAMES} frames in {seconds:.2f} s (first call and decode included), "
        f"launches {launches} [{card}]")
    for k in VMAF_FEATURES:
        log(f"CLI (d) {k}: {scores[k].tolist()}")
    need(scores["vmaf_motion"][0] == 0.0, f"(d): frame 0's motion is {scores['vmaf_motion'][0]}, want 0.0")
    for name in ("motion_stats", "vif_scale0", "vif_tail", "adm_stats"):
        need(launches[name] == per_batch, f"(d): {name} launched {launches[name]} times, want {per_batch}")
    need(launches["integer_blur"] == 1, f"(d): integer_blur launched {launches['integer_blur']} times, want 1")
    model = os.path.join(tmp, "vmaf_fixture_model.json")
    with open(model, "w") as f:
        json.dump(FIXTURE_MODEL, f)
    fused, fused_launches, seconds = run_cli(
        ref_path, dis_path, dev, ["vmaf"], extra=["--vmaf-model", model], keys=VMAF_FEATURES + ("vmaf",)
    )
    log(f"CLI (d) -m vmaf --vmaf-model (fixture): {FRAMES} frames in {seconds:.2f} s, "
        f"launches {fused_launches}; fused scores {fused['vmaf'].tolist()} [{card}]")
    for k in VMAF_FEATURES:
        need(np.array_equal(fused[k], scores[k]), f"(d): {k} differs between the runs with and without a model")
    for name in INT_KERNELS:
        need(launches[name] == 0, f"(d): the float route launched {name}")
    return scores, fused["vmaf"], launches, model


def run_vmaf_int_path(ref_path: str, dis_path: str, dev, card: str, model: str, float_scores):
    """Phase 4d-int: path (d-int), VMAF's fixed-point features with the
    fixture model through the CLI on the 1080p pair (-m vmaf --vmaf-integer
    --vmaf-model): 16 finite values of each feature and fused score, K-int-VIF
    and K-int-ADM launched four times per batch (a scale, a level), #16 once
    per batch and #17 once, the float VIF and ADM kernels no time; motion
    equal to path (d)'s, vif and adm2 within INT_VS_FLOAT of path (d)'s float
    features.  Returns (the features and fused scores, launches)."""
    per_batch = FRAMES // BATCH
    scores, launches, seconds = run_cli(ref_path, dis_path, dev, ["vmaf"],
                                        extra=["--vmaf-integer", "--vmaf-model", model],
                                        keys=VMAF_FEATURES + ("vmaf",))
    log(f"CLI (d-int) -m vmaf --vmaf-integer --vmaf-model (fixture): {FRAMES} frames in {seconds:.2f} s "
        f"(first call and decode included), launches {launches} [{card}]")
    for k in VMAF_FEATURES + ("vmaf",):
        log(f"CLI (d-int) {k}: {scores[k].tolist()}")
    for name in INT_KERNELS:
        need(launches[name] == 4 * per_batch, f"(d-int): {name} launched {launches[name]} times, want {4 * per_batch}")
    need(launches["motion_stats"] == per_batch and launches["integer_blur"] == 1,
         f"(d-int): motion launched {launches['motion_stats']} / {launches['integer_blur']} times")
    for name in ("vif_scale0", "vif_tail", "adm_stats"):
        need(launches[name] == 0, f"(d-int): the float kernel {name} was launched")
    need(np.array_equal(scores["vmaf_motion"], float_scores["vmaf_motion"]), "(d-int): motion differs from (d)'s")
    for k, tol in INT_VS_FLOAT.items():
        d = float(np.abs(scores[k] - float_scores[k]).max())
        log(f"(d-int) {k} vs path (d)'s float features: max |diff| {d:.3g} (bar {tol})")
        need(d <= tol, f"(d-int) {k} apart from the float feature by {d}")
    return scores, launches


def run_mezz_int_path(ref_path: str, dis_path: str, dev, card: str, float_scores):
    """Phase 4e-int: the pair of phase 4c (10-bit 4:2:2 reference, 8-bit 4:2:0
    encode) through -m vmaf --vmaf-integer: the distorted luma aligned to 10
    bits, both pre-rounded to 8; 16 finite values of each feature, the
    integer kernels four times per batch; the differences from path (e)'s
    float features logged."""
    scores, launches, seconds = run_cli(ref_path, dis_path, dev, ["vmaf"], extra=["--vmaf-integer"])
    log(f"CLI (e-int) 4:2:2 10-bit vs 4:2:0 8-bit, -m vmaf --vmaf-integer: {FRAMES} frames in {seconds:.2f} s "
        f"(first call and decode included), launches {launches} [{card}]")
    batches = launches["motion_stats"]
    need(batches >= FRAMES // BATCH, f"(e-int): {batches} batches, want >= {FRAMES // BATCH}")
    for name in INT_KERNELS:
        need(launches[name] == 4 * batches, f"(e-int): {name} launched {launches[name]} times, want {4 * batches}")
    need(np.array_equal(scores["vmaf_motion"], float_scores["vmaf_motion"]), "(e-int): motion differs from (e)'s")
    for k in VIF + ADM:
        log(f"CLI (e-int) {k}: {scores[k].tolist()}; max |diff| vs path (e)'s float feature "
            f"{float(np.abs(scores[k] - float_scores[k]).max()):.3g}")
    return scores


def run_all6_path(ref_path: str, dis_path: str, dev, card: str, mezz_scores):
    """Phase 4e: path (e), all six metrics on the pair of phase 4c."""
    scores, launches, seconds = run_cli(ref_path, dis_path, dev, ALL6)
    log(f"CLI (e) 4:2:2 10-bit vs 4:2:0 8-bit, all six metrics: {FRAMES} frames in {seconds:.2f} s "
        f"(first call and decode included), launches {launches} [{card}]")
    for k in VMAF_FEATURES:
        log(f"CLI (e) {k}: {scores[k].tolist()}")
    # All six take more device memory per pair: default_batch gives fewer
    # frames per batch than B=8, so the count of batches is #13's.
    batches = launches["xpsnr_block_stats"]
    need(batches >= FRAMES // BATCH, f"(e): {batches} batches, want >= {FRAMES // BATCH}")
    for name in ("motion_stats", "vif_scale0", "vif_tail", "adm_stats"):
        need(launches[name] == batches, f"(e): {name} launched {launches[name]} times, want {batches}")
    need(launches["integer_blur"] == 1, f"(e): integer_blur launched {launches['integer_blur']} times")
    for m in ALL5:
        d = float(np.abs(scores[m] - mezz_scores[m]).max())
        need(d <= TOL[m], f"(e) {m} apart from phase 4c's by {d}")
    return scores, launches


def load_frames(path: str, dev, n: int = BATCH):
    """The first n frames of a Y4M file as (n, h, w) / (n, ch, cw, 2) tensors."""
    from turbo_metrics_tpu_torch.io.y4m import Y4MFrameSource

    src = Y4MFrameSource(open(path, "rb"), path=path)
    frames = [src.get_frame() for _ in range(n)]
    src.close()
    return (torch.from_numpy(np.stack([f.y for f in frames])).to(dev),
            torch.from_numpy(np.stack([f.uv for f in frames])).to(dev))


def load_pair(ref_path: str, dis_path: str, dev, n: int = BATCH):
    """The first n frame pairs as (2, n, h, w) / (2, n, ch, cw, 2) tensors."""
    (y_r, uv_r), (y_d, uv_d) = load_frames(ref_path, dev, n), load_frames(dis_path, dev, n)
    return torch.stack([y_r, y_d]), torch.stack([uv_r, uv_d])


def check_close(name, got, want, rtol, atol) -> float:
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    need(not bool(bad.any()),
         f"{name}: {int(bad.sum())} values beyond rtol {rtol} / atol {atol}, max err {err.max().item():.3g}")
    return err.max().item()


def check_parity(y2, uv2, model, cli_scores):
    """Phase 5: each kernel against its plain twin on the same inputs at the
    main path's shapes; the kernel path's scores against the twins', the
    five-blur plain chain's and the CLI's.  Returns the max abs errors."""
    from turbo_metrics_tpu_torch.models.ssimulacra2 import (
        subscores_from_sums,
        ssimulacra2_subscores,
        ssimulacra2_subscores_from_yuv,
    )
    from turbo_metrics_tpu_torch.ops import colorspace
    from turbo_metrics_tpu_torch.ops.kernels import scale_stats, scale_tail

    taps, opsin, dims = model.taps, model.opsin, model.dims
    ns = len(dims)
    norms = scale_stats.norms_from_sums
    h0, w0 = dims[0]
    sums_k, lvl1_k = scale_stats.fused_scale0_yuv(y2, uv2, taps, opsin)
    sums_p, lvl1_p = scale_stats.fused_scale0_yuv_ref(y2, uv2, taps, opsin)
    e1 = max(
        check_close("kernel 1 norms", norms(sums_k, h0 * w0), norms(sums_p, h0 * w0), 1e-4, 1e-5),
        check_close("kernel 1 level 1", lvl1_k, lvl1_p, 0.0, 1e-5),
    )
    tail_k = scale_tail.fused_pyramid_tail(lvl1_p, ns - 1, taps, opsin)
    tail_p = scale_tail.fused_pyramid_tail_ref(lvl1_p, ns - 1, taps, opsin)
    e2 = max(
        check_close(f"kernel 2 level {i + 1} norms", norms(tail_k[:, i], h * w),
                    norms(tail_p[:, i], h * w), 1e-4, 1e-5)
        for i, (h, w) in enumerate(dims[1:])
    )
    sub_k = ssimulacra2_subscores_from_yuv(y2, uv2, taps, opsin, num_scales=ns)
    sub_p = subscores_from_sums([sums_p] + list(tail_p.unbind(1)), dims)
    check_close("kernel path sub-scores", sub_k, sub_p, 1e-4, 1e-5)
    need(torch.equal(sub_k, ssimulacra2_subscores_from_yuv(y2, uv2, taps, opsin, num_scales=ns)),
         "kernel path sub-scores differ between two runs on the same input")
    lin = colorspace.yuv420_to_linear_rgb(y2, uv2, backend="jnp")
    sub_chain = ssimulacra2_subscores(lin[0], lin[1], num_scales=ns)
    sc_k, sc_p, sc_c = (model.score(s) for s in (sub_k, sub_p, sub_chain))
    d_plain = float(np.abs(sc_k - sc_p).max())
    d_chain = float(np.abs(sc_k - sc_c).max())
    d_cli = float(np.abs(sc_k - np.asarray(cli_scores[:BATCH])).max())
    need(d_plain <= 0.01 and d_chain <= 0.01 and d_cli <= 0.01,
         f"scores apart: kernel vs twins {d_plain}, vs five-blur chain {d_chain}, vs CLI {d_cli}")
    log(f"kernel path scores {sc_k.tolist()}")
    log(f"max |score diff|: vs twins {d_plain:.3g}, vs five-blur plain chain {d_chain:.3g}, vs CLI {d_cli:.3g}")
    return e1, e2, lvl1_p


def check_multi_parity(y2, uv2, model, qmod, cli_scores):
    """Phase 5a: each multi-metric kernel against its twin on the same
    inputs at the main path's shapes, then the kernel route's per-frame
    values against the plain route's and the CLI's.  Returns the max abs
    errors by kernel, the converted pair buffer and the emitted level 1."""
    from turbo_metrics_tpu_torch.ops import quality
    from turbo_metrics_tpu_torch.ops.kernels import convert, fused_tail, scale_stats, windowed, windowed_tail

    taps, opsin, win, dims = model.taps, model.opsin, qmod.window, model.dims
    h0, w0 = dims[0]
    norms = scale_stats.norms_from_sums
    err = {}
    p_k = convert.yuv420_to_linear_rgb_pair(y2, uv2)
    p12 = convert.yuv420_to_linear_rgb_pair_ref(y2, uv2)
    err["yuv420_to_linear_rgb_pair"] = check_close("conversion", p_k, p12, 0.0, 1e-6)
    s_k, l_k = scale_stats.fused_scale_rgb(p12, taps, opsin)
    s_p, l_p = scale_stats.fused_scale_rgb_ref(p12, taps, opsin)
    err["fused_scale_rgb"] = max(
        check_close("kernel #3 norms", norms(s_k, h0 * w0), norms(s_p, h0 * w0), 1e-4, 1e-5),
        check_close("kernel #3 level 1", l_k, l_p, 0.0, 1e-5),
    )
    # #4 on the same level run as one level: the two-pass per-pixel code
    # that the fused level kernel of #3 must reproduce bit for bit.
    s4 = fused_tail.fused_tail(p12, 1, taps, opsin)[:, 0]
    need(torch.equal(s_k, s4), f"#3 and #4 differ on the {w0}x{h0} B={s_k.shape[0]} level 0: max abs "
         f"diff {float((s_k - s4).abs().max()):.3g}")
    log(f"#3 sums equal to #4's on the {w0}x{h0} B={s_k.shape[0]} linear-RGB level 0")
    del s4
    ss_k, ds_k = windowed.ssim_sums(p12, win, quantize=True, emit_ds=True)
    ss_p, ds_p = windowed.ssim_sums_ref(p12, win, quantize=True, emit_ds=True)
    err["ssim_sums"] = check_close("SSIM sums", ss_k, ss_p, 1e-5, 0.0)
    need(torch.equal(ds_k, ds_p), "the emitted MS-SSIM level 1 differs from the twin's")
    lv, _ = quality._clamp_levels(h0, w0, MS_LEVELS)
    t_k = windowed_tail.msssim_tail(ds_p, lv - 1, win)
    t_p = windowed_tail.msssim_tail_ref(ds_p, lv - 1, win)
    err["msssim_tail"] = check_close("MS-SSIM tail sums", t_k, t_p, 1e-5, 0.0)

    got = multi_step_kernel(y2, uv2, model, qmod)
    want = multi_step_plain(y2, uv2, model)
    for name, tol in (("psnr", 1e-4), ("ssim", 1e-5), ("msssim", 1e-5), ("ssimulacra2", 0.01)):
        d_plain = float(np.abs(got[name] - want[name]).max())
        d_cli = float(np.abs(got[name] - cli_scores[name][:BATCH]).max())
        log(f"{name}: kernel route {got[name].tolist()}")
        log(f"{name}: max |diff| vs plain route {d_plain:.3g}, vs CLI {d_cli:.3g} (tolerance {tol})")
        need(d_plain <= tol and d_cli <= tol, f"{name}: kernel route vs plain {d_plain}, vs CLI {d_cli}")
    return err, p12, ds_p


def multi_step_kernel(y2, uv2, model, qmod) -> dict:
    """The multi-metric device step through the kernels, per-frame values."""
    from turbo_metrics_tpu_torch.ops.kernels import convert

    p12 = convert.yuv420_to_linear_rgb_pair(y2, uv2)
    out = qmod.from_rgb(p12, psnr=True, ssim=True, msssim=True)
    out["ssimulacra2"] = model.score(model.subscores_from_rgb(p12))
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v, dtype=np.float64) for k, v in out.items()}


def multi_step_plain(y2, uv2, model) -> dict:
    """The same step through the plain twins: conversion, the jnp
    formulation of PSNR / SSIM / MS-SSIM on the quantized pair, and the
    SSIMULACRA2 level twins."""
    from turbo_metrics_tpu_torch.models.ssimulacra2 import subscores_from_sums
    from turbo_metrics_tpu_torch.ops import quality
    from turbo_metrics_tpu_torch.ops.colorspace import f32_to_uint8
    from turbo_metrics_tpu_torch.ops.kernels import convert, scale_stats, scale_tail

    p12 = convert.yuv420_to_linear_rgb_pair_ref(y2, uv2)
    q = f32_to_uint8(p12, torch.float32)
    out = {"psnr": quality.psnr(q[0], q[1])}
    out["ssim"], out["msssim"] = quality.ssim_msssim(q[0], q[1], levels=MS_LEVELS, backend="jnp")
    s0, l1 = scale_stats.fused_scale_rgb_ref(p12, model.taps, model.opsin)
    tail = scale_tail.fused_pyramid_tail_ref(l1, model.num_scales - 1, model.taps, model.opsin)
    out["ssimulacra2"] = model.score(subscores_from_sums([s0] + list(tail.unbind(1)), model.dims))
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v, dtype=np.float64) for k, v in out.items()}


def check_mixed_spec(dev) -> None:
    """A pair whose two inputs differ (8-bit reference, 10-bit distorted) on
    a small odd-sized frame: the engine on the card (one conversion launch
    per image into its slot) against the engine on the CPU (the twins)."""
    from turbo_metrics_tpu_torch.color.characteristics import height_fallback
    from turbo_metrics_tpu_torch.engine import Metrics, TurboMetrics
    from turbo_metrics_tpu_torch.io.frame_source import RawFrame

    rng = np.random.default_rng(11)
    h, w, n = 67, 99, 2
    ref, dis = [], []
    for _ in range(n):
        y = rng.integers(16, 236, (h, w))
        uv = rng.integers(16, 241, ((h + 1) // 2, (w + 1) // 2, 2))
        ref.append(RawFrame(y=y.astype(np.uint8), uv=uv.astype(np.uint8), depth=8))
        dis.append(RawFrame(
            y=np.clip(y * 4 + rng.integers(-12, 13, y.shape), 0, 1023).astype(np.uint16),
            uv=np.clip(uv * 4 + rng.integers(-12, 13, uv.shape), 0, 1023).astype(np.uint16),
            depth=10,
        ))
    cc = (height_fallback(h), "limited")
    metrics = Metrics(**{m: True for m in MULTI})
    conv = counted_kernels()["yuv420_to_linear_rgb_pair"]
    before = conv.launches
    got = TurboMetrics(w, h, metrics, batch=n, device=dev).compute_frames(ref, cc, dis, cc)
    need(conv.launches - before == 2, f"mixed specs: {conv.launches - before} conversion launches, want 2")
    want = TurboMetrics(w, h, metrics, batch=n, device="cpu").compute_frames(ref, cc, dis, cc)
    for name, tol in (("psnr", 1e-4), ("ssim", 1e-5), ("msssim", 1e-5), ("ssimulacra2", 0.01)):
        g = np.array([getattr(s, name) for s in got])
        wv = np.array([getattr(s, name) for s in want])
        d = float(np.abs(g - wv).max())
        log(f"mixed 8/10-bit {h}x{w} {name}: card {g.tolist()}, max |diff| vs CPU {d:.3g}")
        need(np.isfinite(g).all() and d <= tol, f"mixed specs {name}: card {g} vs CPU {wv}")


def check_xpsnr_kernel(y16, cli_xpsnr) -> float:
    """Phase 5b, kernel #13: both 1080p batches of the CLI's pair against the
    twin (every grid equal; frame 8's previous frame is frame 7, carried
    across the batch boundary), the twin route's XPSNR against the CLI's;
    then small odd sizes at 10 and 16 bits, a shifted distorted stream and
    int32 luma codes.  Returns the 1080p grids' max abs difference."""
    from turbo_metrics_tpu_torch.ops.kernels import xpsnr
    from turbo_metrics_tpu_torch.ops.xpsnr_ops import frames_db

    ref, dis = y16[0], y16[1]
    _, n, h, w = y16.shape
    twin_db, err, rel = [], 0, 0.0
    for b0 in range(0, n, BATCH):
        prev0 = ref[max(b0 - 1, 0)]
        args = (ref[b0 : b0 + BATCH], dis[b0 : b0 + BATCH], prev0)
        got, want = xpsnr.xpsnr_block_stats(*args), xpsnr.xpsnr_block_stats_ref(*args)
        for k in want:
            need(torch.equal(got[k], want[k]), f"#13 {k} grid differs from the twin's (frames {b0}+)")
            err = max(err, int((got[k] - want[k]).abs().max()))
        twin_db += frames_db(want, width=w, height=h)
        # The weighted SSE the engine takes on the card above 640x480.
        wsse, twin = xpsnr.xpsnr_wsse(got, depth=8), xpsnr.xpsnr_wsse_ref(want, depth=8).to(got["sse"].device)
        need(torch.equal(wsse, xpsnr.xpsnr_wsse(got, depth=8)), f"xpsnr_wsse: two calls differ (frames {b0}+)")
        rel = max(rel, float(((wsse - twin) / twin).abs().max()))
    d = float(np.abs(np.asarray(twin_db) - cli_xpsnr).max())
    log(f"#13 vs twin at {w}x{h}, frames 0-{n - 1}: all grids equal; XPSNR of the twin route vs "
        f"the CLI's: max |diff| {d:.3g} dB; xpsnr_wsse vs its twin: max relative {rel:.3g}")
    need(d <= TOL["xpsnr"], f"XPSNR of the twin route vs the CLI's: {d}")
    need(rel <= 1e-13, f"xpsnr_wsse vs its twin: relative {rel}")
    rng = np.random.default_rng(13)
    hs, ws = 67, 99
    for ref_depth, dis_depth, ref_dtype in (
        (10, 10, np.uint16), (16, 16, np.uint16), (10, 8, np.uint16), (8, 10, np.int32),
    ):
        r = rng.integers(0, 1 << ref_depth, (3, hs, ws))
        # 16 bits: the complement, so that block SSEs pass 2^32 and wrap.
        dd = 65535 - r if ref_depth == 16 else rng.integers(0, 1 << dis_depth, (3, hs, ws))
        prev0 = rng.integers(0, 1 << ref_depth, (hs, ws))
        dis_dtype = np.uint8 if dis_depth == 8 else np.uint16
        r, dd, prev0 = (torch.from_numpy(a.astype(dt)).to(y16.device)
                        for a, dt in ((r, ref_dtype), (dd, dis_dtype), (prev0, ref_dtype)))
        args = (r, dd, prev0)
        kw = dict(dis_shift=ref_depth - dis_depth)
        got, want = xpsnr.xpsnr_block_stats(*args, **kw), xpsnr.xpsnr_block_stats_ref(*args, **kw)
        for k in want:
            need(torch.equal(got[k], want[k]),
                 f"#13 {k} differs from the twin's at {hs}x{ws}, {ref_depth}/{dis_depth} bits")
        log(f"#13 vs twin at {hs}x{ws}, reference {ref_depth}-bit {r.dtype}, distorted "
            f"{dis_depth}-bit {dd.dtype}: all grids equal (max SSE {int(want['sse'].max())})")
    return float(err)


def check_convert_kernel(y422, uv422) -> float:
    """Phase 5b, kernel #5: the 4:2:2 10-bit reference batch of path (c)
    against the twin (atol 1e-6), then 67x99 at every subsampling and
    transfer (1e-4 for PQ).  Returns the 1080p max abs error."""
    from turbo_metrics_tpu_torch.ops import colorspace
    from turbo_metrics_tpu_torch.ops.kernels import convert

    kw = dict(depth=10, chroma=422)
    err = check_close("#5 at 1080p 4:2:2 10-bit", convert.yuv_to_linear_rgb(y422, uv422, **kw),
                      convert.yuv_to_linear_rgb_ref(y422, uv422, **kw), 0.0, 1e-6)
    log(f"#5 vs twin at {WIDTH}x{HEIGHT} 4:2:2 10-bit B={BATCH}: max abs err {err:.3g}")
    rng = np.random.default_rng(5)
    h, w = 67, 99
    for chroma in (420, 422, 444):
        ch, cw = colorspace.chroma_dims(chroma, h, w)
        y = torch.from_numpy(rng.integers(0, 1024, (2, h, w)).astype(np.uint16)).to(y422.device)
        uv = torch.from_numpy(rng.integers(0, 1024, (2, ch, cw, 2)).astype(np.uint16)).to(y422.device)
        for transfer in ("bt709", "srgb", "pq", "hlg", "linear"):
            kw = dict(depth=10, chroma=chroma, transfer=transfer, full_range=transfer == "hlg")
            e = check_close(f"#5 {chroma} {transfer}", convert.yuv_to_linear_rgb(y, uv, **kw),
                            convert.yuv_to_linear_rgb_ref(y, uv, **kw), 0.0,
                            1e-4 if transfer == "pq" else 1e-6)
            log(f"#5 vs twin at {h}x{w} {chroma} 10-bit {transfer}: max abs err {e:.3g}")
    return err


def mezzanine_frames(h: int = 67, w: int = 99, n: int = 3):
    """n seeded frame pairs of a small odd-sized 10-bit 4:2:2 reference and
    an 8-bit 4:2:0 distorted stream (path (e)'s formats), and their colour
    characteristics."""
    from turbo_metrics_tpu_torch.color.characteristics import height_fallback
    from turbo_metrics_tpu_torch.io.frame_source import RawFrame

    rng = np.random.default_rng(17)
    ref, dis = [], []
    for _ in range(n):
        y = rng.integers(64, 941, (h, w))
        uv = rng.integers(64, 961, (h, (w + 1) // 2, 2))
        ref.append(RawFrame(y=y.astype(np.uint16), uv=uv.astype(np.uint16), depth=10, chroma=422))
        dis.append(RawFrame(
            y=np.clip(y // 4 + rng.integers(-6, 7, y.shape), 0, 255).astype(np.uint8),
            uv=np.clip(uv[::2] // 4 + rng.integers(-6, 7, uv[::2].shape), 0, 255).astype(np.uint8),
            depth=8,
        ))
    return ref, dis, (height_fallback(h), "limited")


def check_mezzanine_engine(dev) -> None:
    """Phases 5b and 5c: path (e)'s engine (10-bit 4:2:2 reference, 8-bit
    4:2:0 distorted, all six metrics) on the card against the same engine on
    the CPU, on a small odd-sized pair, 3 frames in batches of 2 (XPSNR and
    motion state chained, the last batch padded)."""
    from turbo_metrics_tpu_torch.engine import Metrics, TurboMetrics

    h, w = 67, 99
    ref, dis, cc = mezzanine_frames(h, w)
    metrics = Metrics(**{m: True for m in ALL6})
    keys = output_keys(ALL6)
    conv = counted_kernels()["yuv_to_linear_rgb"]
    before = conv.launches
    res = {}
    for where in (dev, "cpu"):
        eng = TurboMetrics(w, h, metrics, batch=2, device=where)
        scores = eng.compute_frames(ref[:2], cc, dis[:2], cc) + eng.compute_frames(ref[2:], cc, dis[2:], cc)
        res[str(where)] = {m: np.array([getattr(s, m) for s in scores]) for m in keys}
    need(conv.launches - before == 2, f"path (e) engine: {conv.launches - before} #5 launches, want 2")
    got, want = res[str(dev)], res["cpu"]
    for m in keys:
        d = float(np.abs(got[m] - want[m]).max())
        log(f"path (e) engine {h}x{w} {m}: card {got[m].tolist()}, max |diff| vs CPU {d:.3g}")
        need(np.isfinite(got[m]).all() and d <= TOL[m], f"path (e) engine {m}: card {got[m]} vs CPU {want[m]}")


def vmaf_step(y_ref, y_dis, prev0, kernels: bool) -> dict:
    """VMAF's device step on one 8-bit batch through the kernels (or their
    twins): the motion blur and row SADs, VIF's four scales, ADM's four
    levels."""
    from turbo_metrics_tpu_torch.engine import vmaf_pair
    from turbo_metrics_tpu_torch.ops.kernels import adm, motion, vif

    pair = vmaf_pair(y_ref, y_dis, 8, 8)
    if kernels:
        return {"motion": motion.motion_stats(y_ref, prev0), "vif": vif.vif_scale_stats(pair),
                "adm": adm.adm_stats(pair)}
    sums0, level1 = vif.vif_scale0_ref(pair)
    return {"motion": motion.motion_stats_ref(y_ref, prev0),
            "vif": torch.cat([sums0[:, None], vif.vif_tail_ref(level1)], dim=1),
            "adm": adm.adm_stats_ref(pair)}


def check_vmaf_kernels(y16, cli_vmaf) -> dict:
    """Phase 5c: kernels #16 and #17 against their twins on both 1080p
    batches of the CLI's pair (frame 8's previous frame is frame 7's blur,
    across the batch boundary), on two seeded B=8 batches of 10-bit u16
    luma at 1080p (path (e)'s type and width) and at 10 and 16 bits on
    small odd sizes; #14, #15 and #18 against their twins on the first
    batch; the features of the twins' route against the CLI's.  Returns the max abs errors by
    kernel and the first batch's VIF/ADM pair."""
    from turbo_metrics_tpu_torch.engine import vmaf_pair
    from turbo_metrics_tpu_torch.ops import adm as adm_ops
    from turbo_metrics_tpu_torch.ops import vif as vif_ops
    from turbo_metrics_tpu_torch.ops.kernels import adm, motion, vif
    from turbo_metrics_tpu_torch.ops.vmaf_motion import motion_score

    ref, dis = y16[0], y16[1]
    _, n, h, w = y16.shape
    err = {}
    first = motion.integer_blur(ref[:1])
    first_p = motion.integer_blur_ref(ref[:1])
    need(torch.equal(first.to(torch.int32), first_p.to(torch.int32)), "#17 blurred plane differs from the twin's")
    err["integer_blur"] = 0.0
    prev0, motion_scores = first_p[0], []
    for b0 in range(0, n, BATCH):
        got = motion.motion_stats(ref[b0 : b0 + BATCH], prev0)
        want = motion.motion_stats_ref(ref[b0 : b0 + BATCH], prev0)
        need(torch.equal(got["blurred"].to(torch.int32), want["blurred"].to(torch.int32)),
             f"#16 blurred planes differ from the twin's (frames {b0}+)")
        need(torch.equal(got["sad_rows"], want["sad_rows"]), f"#16 row SADs differ from the twin's (frames {b0}+)")
        motion_scores += [motion_score(int(v), w, h) for v in want["sad_rows"].sum(dim=-1).cpu()]
        prev0 = want["blurred"][-1].contiguous()
    motion_scores[0] = 0.0
    err["motion_stats"] = 0.0
    need(np.array_equal(np.asarray(motion_scores), cli_vmaf["vmaf_motion"]),
         "motion of the twins' route differs from the CLI's")
    log(f"#16/#17 vs twins at {w}x{h}, frames 0-{n - 1}: blurred planes and row SADs equal; "
        "motion equal to the CLI's")
    # Path (e)'s luma: 10-bit u16 at the full width (whole, aligned chunks,
    # eight row segments), two batches of B=8 across the batch boundary.
    rng = np.random.default_rng(16)
    y10 = torch.from_numpy(rng.integers(0, 1 << 10, (2 * BATCH, h, w)).astype(np.uint16)).to(y16.device)
    prev0 = motion.integer_blur_ref(y10[:1], depth=10)[0]
    need(torch.equal(motion.integer_blur(y10[:1], depth=10).to(torch.int32), prev0[None].to(torch.int32)),
         f"#17 differs from the twin on 10-bit {w}x{h} luma")
    for b0 in range(0, 2 * BATCH, BATCH):
        got = motion.motion_stats(y10[b0 : b0 + BATCH], prev0, depth=10)
        want = motion.motion_stats_ref(y10[b0 : b0 + BATCH], prev0, depth=10)
        need(torch.equal(got["blurred"].to(torch.int32), want["blurred"].to(torch.int32))
             and torch.equal(got["sad_rows"], want["sad_rows"]),
             f"#16 differs from the twin on 10-bit {w}x{h} luma, frames {b0}+")
        prev0 = want["blurred"][-1].contiguous()
    log(f"#16/#17 vs twins at {w}x{h} 10-bit u16, B={BATCH}, frames 0-{2 * BATCH - 1}: equal")
    for depth, hs, ws in ((10, 67, 99), (16, 35, 131)):
        y = torch.from_numpy(rng.integers(0, 1 << depth, (3, hs, ws)).astype(np.uint16)).to(y16.device)
        p0 = torch.from_numpy(rng.integers(0, 1 << 16, (hs, ws)).astype(np.uint16)).to(y16.device)
        got, want = motion.motion_stats(y, p0, depth=depth), motion.motion_stats_ref(y, p0, depth=depth)
        need(torch.equal(got["blurred"].to(torch.int32), want["blurred"].to(torch.int32))
             and torch.equal(got["sad_rows"], want["sad_rows"]), f"#16 differs from the twin at {depth} bits")
        need(torch.equal(motion.integer_blur(y, depth=depth).to(torch.int32), want["blurred"].to(torch.int32)),
             f"#17 differs from the twin at {depth} bits")
        log(f"#16/#17 vs twins at {hs}x{ws} {depth}-bit: equal")

    pair = vmaf_pair(ref[:BATCH], dis[:BATCH], 8, 8)
    s0_k, l1_k = vif.vif_scale0(pair)
    s0_p, l1_p = vif.vif_scale0_ref(pair)
    err["vif_scale0"] = max(check_close("#14 sums", s0_k, s0_p, 1e-4, 1e-5),
                            check_close("#14 level 1", l1_k, l1_p, 1e-5, 1e-4))
    t_k, t_p = vif.vif_tail(l1_p), vif.vif_tail_ref(l1_p)
    err["vif_tail"] = check_close("#15 sums", t_k, t_p, 1e-4, 1e-5)
    sc_k = vif_ops.vif_scores(torch.cat([s0_k[:, None], t_k], dim=1).cpu().numpy())
    sc_p = vif_ops.vif_scores(torch.cat([s0_p[:, None], t_p], dim=1).cpu().numpy())
    for k in sc_p:
        d = float(np.abs(sc_k[k] - sc_p[k]).max())
        d_cli = float(np.abs(sc_p[k] - cli_vmaf["vmaf_" + k][:BATCH]).max())
        log(f"#14/#15 {k}: max |diff| vs twins {d:.3g}, twins vs CLI {d_cli:.3g}")
        need(d <= 1e-5 and d_cli <= 1e-5, f"VIF {k}: kernels vs twins {d}, twins vs CLI {d_cli}")
    a_k, a_p = adm.adm_stats(pair), adm.adm_stats_ref(pair)
    err["adm_stats"] = check_close("#18 sums", a_k, a_p, 1e-4, 0.0)
    log(f"#18 sums: max rel diff vs twin {float(((a_k - a_p).abs() / a_p.abs().clamp_min(1e-30)).max()):.3g} "
        "(angle gate evaluated in the twin's order: no flip possible unless a band differs)")
    ad_k, ad_p = (adm_ops.adm_score(a.cpu().numpy(), h, w) for a in (a_k, a_p))
    for k in ad_p:
        d = float(np.abs(ad_k[k] - ad_p[k]).max())
        key = "vmaf_adm" if k == "adm2" else "vmaf_" + k
        d_cli = float(np.abs(ad_p[k] - cli_vmaf[key][:BATCH]).max())
        log(f"#18 {k}: max |diff| vs twin {d:.3g}, twin vs CLI {d_cli:.3g}")
        need(d <= 1e-4 and d_cli <= 1e-4, f"ADM {k}: kernel vs twin {d}, twin vs CLI {d_cli}")
    return err, pair, l1_p


def check_integer_pair(pair, depth: int, what: str) -> dict:
    """K-int-VIF and K-int-ADM against their twins (run on the card) on one
    pair of luma codes: every integer surface equal (VIF's moments and means
    per scale and each scale's input; ADM's six bands and gate per level),
    VIF's sums per scale within rel 1e-6, ADM's within rel 1e-5.  Returns the
    max abs errors of the sums and the twins' sums."""
    from turbo_metrics_tpu_torch.ops import integer_adm as iadm_ops
    from turbo_metrics_tpu_torch.ops import integer_vif as ivif_ops
    from turbo_metrics_tpu_torch.ops.kernels import integer_adm, integer_vif

    planes, planes_p = integer_vif.integer_vif_planes(pair, depth=depth), integer_vif.integer_vif_planes_ref(pair,
                                                                                                          depth=depth)
    for k, (got, want) in enumerate(zip(planes, planes_p)):
        for key in got:
            need(torch.equal(got[key], want[key]), f"K-int-VIF {key} at scale {k} differs from the twin's ({what})")
    sums_p = torch.stack([ivif_ops.scale_log_sums(p["s11"], p["s22"], p["s12"]) for p in planes_p], dim=1)
    sums = integer_vif.integer_vif_stats(pair, depth=depth)
    need(torch.equal(sums, integer_vif.integer_vif_stats(pair, depth=depth)), f"K-int-VIF not deterministic ({what})")
    e_v = check_close(f"K-int-VIF sums ({what})", sums, sums_p, 1e-6, 0.0)
    levels, levels_p = integer_adm.integer_adm_levels(pair, depth=depth), integer_adm.integer_adm_levels_ref(pair,
                                                                                                          depth=depth)
    for li, (got, want) in enumerate(zip(levels, levels_p)):
        for key in want:
            need(torch.equal(got[key], want[key]), f"K-int-ADM {key} at level {li} differs from the twin's ({what})")
    adm_p = torch.stack([iadm_ops.level_stats(lv, li) for li, lv in enumerate(levels_p)], dim=1)
    adm = integer_adm.integer_adm_stats(pair, depth=depth)
    e_a = check_close(f"K-int-ADM sums ({what})", adm, adm_p, 1e-5, 0.0)
    rel_v = float(((sums - sums_p).abs() / sums_p.abs().clamp_min(1e-30)).max())
    rel_a = float(((adm - adm_p).abs() / adm_p.abs().clamp_min(1e-30)).max())
    log(f"K-int-VIF / K-int-ADM vs twins, {what}: integer surfaces equal; sums max rel diff {rel_v:.3g} / "
        f"{rel_a:.3g}")
    return {"integer_vif_stats": e_v, "integer_adm_stats": e_a, "vif": sums_p, "adm": adm_p}


def check_integer_kernels(y16, cli_int) -> tuple:
    """Phase 5j: K-int-VIF and K-int-ADM against their twins on the card at
    1080p B=8: the first batch of path (d-int)'s 8-bit u8 luma, and a seeded
    10-bit u16 batch (pre-rounded to 8 bits in the kernels); the features of
    the twins' sums against the CLI's (d-int) (VIF 1e-5, ADM 1e-4); then
    check_integer_edges.  Returns the max abs errors by kernel and the 8-bit
    pair."""
    from turbo_metrics_tpu_torch.ops.adm import adm_score
    from turbo_metrics_tpu_torch.ops.vif import vif_scores

    pair = y16[:, :BATCH].contiguous()
    _, _, h, w = pair.shape
    res = check_integer_pair(pair, 8, f"{w}x{h} u8 B={BATCH}")
    feats = {f"vmaf_{k}": v for k, v in vif_scores(res["vif"].cpu().numpy()).items()}
    feats.update({"vmaf_adm" if k == "adm2" else f"vmaf_{k}": v
                  for k, v in adm_score(res["adm"].cpu().numpy(), h, w).items()})
    for k in VIF + ADM:
        d = float(np.abs(feats[k] - cli_int[k][:BATCH]).max())
        need(d <= TOL[k], f"(d-int) {k}: twins vs CLI {d}")
    log(f"(d-int) features of the twins' sums vs the CLI's, frames 0-{BATCH - 1}: within VIF 1e-5, ADM 1e-4")
    rng = np.random.default_rng(12)
    y10 = torch.from_numpy(rng.integers(0, 1 << 10, (BATCH, h, w)).astype(np.uint16)).to(y16.device)
    d10 = (y10.to(torch.int32) + torch.from_numpy(rng.integers(-24, 25, (BATCH, h, w))).to(y16.device))
    pair10 = torch.stack([y10, d10.clamp(0, 1023).to(torch.uint16)])
    res10 = check_integer_pair(pair10, 10, f"{w}x{h} 10-bit u16 B={BATCH}")
    err = {k: max(res[k], res10[k]) for k in INT_KERNELS}
    check_integer_edges(y16.device)
    return err, pair


def check_integer_edges(dev) -> None:
    """Phase 5j, INT_EDGE_SIZES: K-int-VIF and K-int-ADM against their twins
    (check_integer_pair) on seeded B=2 pairs whose distorted image is the
    reference plus noise, each luma type, 8 to 16 bits."""
    rng = np.random.default_rng(21)
    for h, w, depth, dt in INT_EDGE_SIZES:
        hi = min(1 << depth, int(np.iinfo(dt).max) + 1)
        r = rng.integers(0, hi, (2, h, w))
        d = np.clip(r + rng.integers(-hi // 16, hi // 16 + 1, r.shape), 0, hi - 1)
        pair = torch.from_numpy(np.stack([r, d]).astype(dt)).to(dev)
        check_integer_pair(pair, depth, f"{h}x{w} {depth}-bit {np.dtype(dt).name} B=2")


def check_integer_engine(dev) -> None:
    """Phase 5j: the engine with vmaf_integer on the card against the same
    engine on the CPU on mezzanine_frames (phase 5b's pair), 3 frames in
    batches of 2: motion equal, VIF 1e-5, ADM 1e-4."""
    from turbo_metrics_tpu_torch.engine import Metrics, TurboMetrics

    h, w = 67, 99
    ref, dis, cc = mezzanine_frames(h, w)
    res = {}
    kiv = counted_kernels()["integer_vif_stats"]
    before = kiv.launches
    for where in (dev, "cpu"):
        eng = TurboMetrics(w, h, Metrics(vmaf=True), batch=2, device=where, vmaf_integer=True)
        scores = eng.compute_frames(ref[:2], cc, dis[:2], cc) + eng.compute_frames(ref[2:], cc, dis[2:], cc)
        res[str(where)] = {m: np.array([getattr(s, m) for s in scores]) for m in VMAF_FEATURES}
    need(kiv.launches - before == 8, f"integer engine: {kiv.launches - before} K-int-VIF launches, want 8")
    got, want = res[str(dev)], res["cpu"]
    for m in VMAF_FEATURES:
        d = float(np.abs(got[m] - want[m]).max())
        need(np.isfinite(got[m]).all() and d <= TOL[m], f"integer engine {m}: card {got[m]} vs CPU {want[m]}")
    log(f"engine vmaf_integer {h}x{w} 10-bit 4:2:2 vs 8-bit 4:2:0 on the card vs the CPU: motion equal, "
        f"VIF within 1e-5, ADM within 1e-4; vif {got['vmaf_vif'].tolist()}")


def vmaf_int_step(y_ref, y_dis, prev0, kernels: bool) -> dict:
    """VMAF's device step with vmaf_integer on one 8-bit batch through the
    kernels (or their twins): the pair of codes, the motion blur and row
    SADs, K-int-VIF, K-int-ADM."""
    from turbo_metrics_tpu_torch.engine import vmaf_code_pair
    from turbo_metrics_tpu_torch.ops.kernels import integer_adm, integer_vif, motion

    pair = vmaf_code_pair(y_ref, y_dis, 8, 8)
    if kernels:
        return {"motion": motion.motion_stats(y_ref, prev0), "vif": integer_vif.integer_vif_stats(pair),
                "adm": integer_adm.integer_adm_stats(pair)}
    return {"motion": motion.motion_stats_ref(y_ref, prev0), "vif": integer_vif.integer_vif_stats_ref(pair),
            "adm": integer_adm.integer_adm_stats_ref(pair)}


# The run's peak device memory up to the last reset of the peak counter.
RUN_PEAK = [0]


def step_peak_mib(fn, dev) -> float:
    """Peak device memory that one fn() call allocates above what is
    allocated before it, in MiB (torch.cuda.max_memory_allocated).  The
    run's peak so far goes into RUN_PEAK before the counter is reset."""
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    RUN_PEAK[0] = max(RUN_PEAK[0], torch.cuda.max_memory_allocated(dev))
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return (torch.cuda.max_memory_allocated(dev) - base) / 2**20


def s2_level_flops(bsz: int, h: int, w: int) -> float:
    return bsz * h * w * (2 * F_XYB + 3 * F_S2)


def ssim_level_flops(bsz: int, h: int, w: int, quantize: bool, emit: bool) -> float:
    per_plane = (
        h * w * (F_QUANT if quantize else 0) + h * (w - 10) * F_SSIM_ROW
        + (h - 10) * (w - 10) * F_SSIM_COL + ((h // 2) * (w // 2) * F_HALFPOOL if emit else 0)
    )
    return 3 * bsz * per_plane


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(nb: float, flops: float, peak_ops: float = PEAK_F32_PER_S, issue: float = 0.0):
    """(least ms, what bounds it): bytes over the memory rate or operations
    over the rate of their type (f32 unless given) plus ``issue`` ms of
    counted instructions, whichever takes longer."""
    t_bytes, t_ops = nb / PEAK_BYTES_PER_S * 1e3, flops / peak_ops * 1e3 + issue
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_other_formats(model) -> None:
    """Kernel paths the 1080p pair does not reach (u16 planes, the other
    transfers, full range, odd sizes) against the twins, on seeded
    independent random pairs at 2x67x99."""
    from turbo_metrics_tpu_torch.models.ssimulacra2 import (
        ssimulacra2_subscores_from_yuv,
        subscores_from_sums,
    )
    from turbo_metrics_tpu_torch.ops.downscale import scale_dims
    from turbo_metrics_tpu_torch.ops.kernels import scale_stats, scale_tail

    rng = np.random.default_rng(7)
    h, w = 67, 99
    dims = scale_dims(h, w)
    for depth, matrix, transfer, full in (
        (10, "bt2020", "pq", False), (10, "bt709", "hlg", True),
        (8, "bt601_625", "srgb", True), (12, "bt709", "linear", False),
    ):
        dt = np.uint8 if depth == 8 else np.uint16
        hi = 1 << depth
        y2 = torch.from_numpy(rng.integers(0, hi, (2, 2, h, w)).astype(dt)).to(model.device)
        uv2 = torch.from_numpy(
            rng.integers(0, hi, (2, 2, (h + 1) // 2, (w + 1) // 2, 2)).astype(dt)
        ).to(model.device)
        kw = dict(depth=depth, matrix=matrix, transfer=transfer, full_range=full)
        sub_k = ssimulacra2_subscores_from_yuv(y2, uv2, model.taps, model.opsin, num_scales=len(dims), **kw)
        s0, l1 = scale_stats.fused_scale0_yuv_ref(y2, uv2, model.taps, model.opsin, **kw)
        rest = scale_tail.fused_pyramid_tail_ref(l1, len(dims) - 1, model.taps, model.opsin)
        sub_p = subscores_from_sums([s0] + list(rest.unbind(1)), dims)
        err = check_close(f"{depth}-bit {matrix} {transfer} full={full}", sub_k, sub_p, 1e-4, 1e-5)
        log(f"{depth}-bit {matrix} {transfer} full={full} {h}x{w}: max abs err {err:.3g}")


def check_level_blocks(lib, card: str) -> None:
    """Phase 2: the Python counts of 32x8 partial tiles that size the level
    scratch (scale_stats.level_blocks, windowed.ssim_blocks,
    vif.vif_blocks, adm.adm_blocks) against the library's, on sizes that
    cross tile edges and on every level of the 1080p (and, for SSIMULACRA2,
    4K) pyramids; then what each fused level kernel instance takes on this
    card."""
    import ctypes

    from turbo_metrics_tpu_torch.ops import adm as adm_ops
    from turbo_metrics_tpu_torch.ops import quality
    from turbo_metrics_tpu_torch.ops.downscale import scale_dims
    from turbo_metrics_tpu_torch.ops.kernels import _build, adm, scale_stats, vif, windowed

    sizes = [(1, 1), (33, 65), (67, 99)] + scale_dims(HEIGHT, WIDTH) + scale_dims(UHD_HEIGHT, UHD_WIDTH)
    for h, w in sizes:
        got, want = lib.tm_level_blocks(h, w), scale_stats.level_blocks(h, w)
        need(got == want, f"tm_level_blocks({h}, {w}) = {got}, level_blocks = {want}")
    lv, _ = quality._clamp_levels(HEIGHT, WIDTH, MS_LEVELS)
    ssim_sizes = [(11, 11), (42, 43), (67, 99)] + [(HEIGHT >> i, WIDTH >> i) for i in range(lv)]
    for h, w in ssim_sizes:
        got, want = lib.tm_ssim_blocks(h, w), windowed.ssim_blocks(h, w)
        need(got == want, f"tm_ssim_blocks({h}, {w}) = {got}, ssim_blocks = {want}")
    vif_sizes = [(13, 21), (67, 99), (35, 131)]
    h, w = HEIGHT, WIDTH
    for _ in range(4):
        vif_sizes.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    for h, w in vif_sizes:
        got, want = lib.tm_vif_blocks(h, w), vif.vif_blocks(h, w)
        need(got == want, f"tm_vif_blocks({h}, {w}) = {got}, vif_blocks = {want}")
    adm_levels = []
    for h, w in ADM_EDGE_SIZES:
        adm_levels += adm_ops.band_sizes(h, w)
    for ch, cw in adm_levels:
        top, _, left, _ = adm_ops.center_region(ch, cw)
        got, want = lib.tm_adm_blocks(ch, cw, top, left), adm.adm_blocks(ch, cw, top, left)
        need(got == want, f"tm_adm_blocks({ch}, {cw}, {top}, {left}) = {got}, adm_blocks = {want}")
    log(f"tm_level_blocks equals level_blocks on {len(sizes)} sizes, tm_ssim_blocks ssim_blocks on "
        f"{len(ssim_sizes)}, tm_vif_blocks vif_blocks on {len(vif_sizes)}, tm_adm_blocks adm_blocks on "
        f"{len(adm_levels)} band planes")
    a = (ctypes.c_int * 4)()
    _build.check(lib.tm_level_tile_attrs(a), "tm_level_tile_attrs")
    log(f"level_tile_kernel: {a[0]} registers, {a[1]} B of shared memory per block, "
        f"{a[2]} blocks per SM [{card}]")
    for q in (1, 0):
        _build.check(lib.tm_ssim_tile_attrs(q, a), "tm_ssim_tile_attrs")
        log(f"ssim_tile_kernel<{'true' if q else 'false'}>: {a[0]} registers, {a[1]} B of static shared "
            f"memory per block, {a[2]} blocks per SM, {a[3]} B of local memory (spills) [{card}]")
    for scale, inst in enumerate(("8, 4", "4, 2", "2, 1", "1, 0")):
        _build.check(lib.tm_vif_tile_attrs(scale, a), "tm_vif_tile_attrs")
        log(f"vif_tile_kernel<{inst}> (scale {scale}): {a[0]} registers, {a[1]} B of dynamic shared "
            f"memory per block, {a[2]} blocks per SM, {a[3]} B of local memory (spills) [{card}]")
    _build.check(lib.tm_adm_tile_attrs(a), "tm_adm_tile_attrs")
    log(f"adm_tile_kernel: {a[0]} registers, {a[1]} B of dynamic shared memory per block, {a[2]} blocks "
        f"per SM, {a[3]} B of local memory (spills) [{card}]")
    for h, w in vif_sizes:
        got, want = lib.tm_integer_vif_blocks(h, w), vif.vif_blocks(h, w)
        need(got == want, f"tm_integer_vif_blocks({h}, {w}) = {got}, vif_blocks = {want}")
    for ch, cw in adm_levels:
        top, _, left, _ = adm_ops.center_region(ch, cw)
        got, want = lib.tm_integer_adm_blocks(ch, cw, top, left), adm.adm_blocks(ch, cw, top, left)
        need(got == want, f"tm_integer_adm_blocks({ch}, {cw}, {top}, {left}) = {got}, adm_blocks = {want}")
    types = ("unsigned char", "unsigned short", "int")
    for chk in (0, 1):
        for scale, ty, narrow, inst in ((0, 0, 1, "8, 4"), (0, 1, 0, "8, 4"), (0, 2, 0, "8, 4"),
                                        (1, 1, 1, "4, 2"), (1, 1, 0, "4, 2"), (2, 1, 1, "2, 1"), (2, 1, 0, "2, 1"),
                                        (3, 1, 1, "1, 0"), (3, 1, 0, "1, 0")):
            _build.check(lib.tm_integer_vif_attrs(scale, ty, narrow, chk, a), "tm_integer_vif_attrs")
            log(f"integer_vif_kernel<{types[ty]}, {inst}, {'true' if narrow else 'false'}, "
                f"{'true' if chk else 'false'}> (scale {scale}): {a[0]} registers, {a[1]} B of dynamic shared "
                f"memory per block, {a[2]} blocks per SM, {a[3]} B of local memory (spills) [{card}]")
        for codes, ty in ((1, 0), (1, 1), (1, 2), (0, 2)):
            _build.check(lib.tm_integer_adm_attrs(codes, ty, chk, a), "tm_integer_adm_attrs")
            log(f"integer_adm_kernel<{types[ty]}, {'true' if codes else 'false'}, {'true' if chk else 'false'}>: "
                f"{a[0]} registers, {a[1]} B of dynamic shared memory per block, {a[2]} blocks per SM, {a[3]} B "
                f"of local memory (spills) [{card}]")
    for code, name in enumerate(("unsigned char", "unsigned short", "int")):
        _build.check(lib.tm_motion_attrs(code, a), "tm_motion_attrs")
        log(f"motion_kernel<{name}>: {a[0]} registers, {a[1]} B of static shared memory per block, {a[2]} "
            f"blocks per SM, {a[3]} B of local memory (spills) [{card}]")
    for is16, sub, tf, what in ((1, 422, 0, "#5, 10-bit 4:2:2 BT.709"), (0, 420, 0, "#6, 8-bit 4:2:0 BT.709"),
                                (1, 444, 2, "#5, 16-bit 4:4:4 PQ")):
        _build.check(lib.tm_convert_attributes(is16, sub, tf, a), "tm_convert_attributes")
        log(f"yuv_to_rgb_kernel ({what}): {a[0]} registers, {a[1]} B of static shared memory per block, {a[2]} "
            f"blocks per SM, {a[3]} B of local memory (spills) [{card}]")
    for ref_t, dis_t, shift, what in ((0, 0, 0, "u8 vs u8"), (1, 0, 2, "10-bit u16 vs u8"), (0, 0, 1, "u8 vs u8 shifted"),
                                      (1, 1, 0, "u16 vs u16"), (2, 2, 0, "int32 vs int32"), (2, 0, 2, "int32 vs u8")):
        _build.check(lib.tm_xpsnr_attributes(ref_t, dis_t, shift, a), "tm_xpsnr_attributes")
        log(f"xpsnr_kernel ({what}): {a[0]} registers, {a[1]} B of static shared memory per block, {a[2]} "
            f"blocks per SM, {a[3]} B of local memory (spills) [{card}]")
    t = (ctypes.c_int * 5)()
    _build.check(lib.tm_fused_tail_attrs(t), "tm_fused_tail_attrs")
    log(f"fused_tail_kernel: {t[0]} registers, {t[1]} B of static shared memory per block, {t[2]} blocks per "
        f"SM, {t[3]} B of local memory (spills), {t[4]} blocks per launch [{card}]")
    _build.check(lib.tm_blur_probe_attrs(t), "tm_blur_probe_attrs")
    log(f"blur_probe_kernel (#19): {t[0]} registers, {t[1]} B of static shared memory per block, {t[2]} blocks "
        f"per SM, {t[3]} B of local memory (spills) [{card}]")


def check_ssim_edges(dev, win) -> float:
    """Phase 5a, sizes that cross the 32x32 tile's edges: #11 with
    quantization and emission on 11x11 (one valid pixel), 42x43 and 67x99
    (sums rtol 1e-5, the emitted level equal), and #12 from 67x99 down to
    its last level (rtol 1e-5), each on a seeded pair whose distorted image
    is the reference plus noise.  Returns the largest relative error."""
    from turbo_metrics_tpu_torch.ops.kernels import windowed, windowed_tail

    g = torch.Generator(device=dev).manual_seed(11)

    def pair(h, w, scale):
        ref = torch.rand((2, 3, h, w), generator=g, device=dev) * scale
        noise = torch.randn((2, 3, h, w), generator=g, device=dev) * (0.05 * scale)
        return torch.stack([ref, (ref + noise).clamp(0, scale)]).contiguous()

    worst = 0.0
    for h, w in ((11, 11), (42, 43), (67, 99)):
        p12 = pair(h, w, 1.0)
        s_k, d_k = windowed.ssim_sums(p12, win, quantize=True, emit_ds=True)
        s_p, d_p = windowed.ssim_sums_ref(p12, win, quantize=True, emit_ds=True)
        e = check_close(f"#11 sums at {h}x{w}", s_k, s_p, 1e-5, 0.0)
        need(torch.equal(d_k, d_p), f"#11 emitted level at {h}x{w} differs from the twin's")
        rel = float(((s_k - s_p).abs() / s_p.abs()).max())
        worst = max(worst, rel)
        log(f"#11 vs twin at {h}x{w} B=2 (quantize, emit): sums max abs err {e:.3g}, max rel {rel:.3g}; "
            "emitted level equal")
    q = torch.round(pair(67, 99, 255.0))
    n = 1
    while min(67, 99) >> n >= 11:
        n += 1
    t_k, t_p = windowed_tail.msssim_tail(q, n, win), windowed_tail.msssim_tail_ref(q, n, win)
    e = check_close(f"#12 sums from 67x99, {n} levels", t_k, t_p, 1e-5, 0.0)
    rel = float(((t_k - t_p).abs() / t_p.abs()).max())
    log(f"#12 vs twin from 67x99 B=2, {n} levels: sums max abs err {e:.3g}, max rel {rel:.3g}")
    return max(worst, rel)


def check_vif_edges(dev) -> None:
    """Phase 5c, sizes that cross the 32x32 tile's edges: #14 and #15 on
    13x21 (the 17-tap window wider than the plane), 67x99 and 35x131, on a
    seeded 8-bit pair whose distorted image is the reference plus noise:
    sums rtol 1e-4 / atol 1e-5 per scale, #14's emitted level rtol 1e-5 /
    atol 1e-4."""
    from turbo_metrics_tpu_torch.ops.kernels import vif

    g = torch.Generator(device=dev).manual_seed(14)
    for h, w in ((13, 21), (67, 99), (35, 131)):
        ref = torch.randint(0, 256, (2, h, w), generator=g, device=dev).float()
        dis = (ref + torch.randint(-12, 13, (2, h, w), generator=g, device=dev)).clamp(0, 255)
        p = torch.stack([ref, dis]).contiguous()
        s0_k, l1_k = vif.vif_scale0(p)
        s0_p, l1_p = vif.vif_scale0_ref(p)
        e0 = max(check_close(f"#14 sums at {h}x{w}", s0_k, s0_p, 1e-4, 1e-5),
                 check_close(f"#14 level 1 at {h}x{w}", l1_k, l1_p, 1e-5, 1e-4))
        e1 = check_close(f"#15 sums from {h}x{w}", vif.vif_tail(l1_p), vif.vif_tail_ref(l1_p), 1e-4, 1e-5)
        log(f"#14 vs twin at {h}x{w} B=2: max abs err {e0:.3g}; #15 from its level 1: {e1:.3g}")


def check_adm_convert_edges(dev) -> None:
    """Phase 5g: #18 against its twin at ADM_EDGE_SIZES (sums rtol 1e-4), on
    a seeded 8-bit pair whose distorted image is the reference plus noise;
    #6 and #5 against their twins at widths that are not a multiple of 8 or
    4 and odd heights, 8- and 16-bit, at 4:2:0, 4:2:2 and 4:4:4 (atol 1e-6,
    1e-4 for PQ): the ragged ends of rows and the unaligned chunks."""
    from turbo_metrics_tpu_torch.ops import colorspace
    from turbo_metrics_tpu_torch.ops.kernels import adm, convert

    g = torch.Generator(device=dev).manual_seed(18)
    for h, w in ADM_EDGE_SIZES:
        ref = torch.randint(0, 256, (2, h, w), generator=g, device=dev).float()
        dis = (ref + torch.randint(-12, 13, (2, h, w), generator=g, device=dev)).clamp(0, 255)
        p = torch.stack([ref, dis]).contiguous()
        got, want = adm.adm_stats(p), adm.adm_stats_ref(p)
        check_close(f"#18 sums at {h}x{w}", got, want, 1e-4, 0.0)
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        log(f"#18 vs twin at {h}x{w} B=2: sums max rel diff {rel:.3g}")
    rng = np.random.default_rng(6)
    for h, w in ((67, 99), (35, 131), (9, 30), (1, 1)):
        for depth in (8, 16):
            dt = np.uint8 if depth == 8 else np.uint16
            for chroma in (420, 422, 444):
                ch, cw = colorspace.chroma_dims(chroma, h, w)
                y = torch.from_numpy(rng.integers(0, 1 << depth, (2, 2, h, w)).astype(dt)).to(dev)
                uv = torch.from_numpy(rng.integers(0, 1 << depth, (2, 2, ch, cw, 2)).astype(dt)).to(dev)
                for transfer in ("bt709", "pq"):
                    tol = 1e-4 if transfer == "pq" else 1e-6
                    kw = dict(depth=depth, transfer=transfer)
                    e5 = check_close(f"#5 {chroma} {depth}-bit {transfer} at {h}x{w}",
                                     convert.yuv_to_linear_rgb(y, uv, chroma=chroma, **kw),
                                     convert.yuv_to_linear_rgb_ref(y, uv, chroma=chroma, **kw), 0.0, tol)
                    msg = f"#5 {chroma} {depth}-bit {transfer} at {h}x{w}: max abs err {e5:.3g}"
                    if chroma == 420:
                        e6 = check_close(f"#6 {depth}-bit {transfer} at {h}x{w}",
                                         convert.yuv420_to_linear_rgb_pair(y, uv, **kw),
                                         convert.yuv420_to_linear_rgb_pair_ref(y, uv, **kw), 0.0, tol)
                        msg += f"; #6 {e6:.3g}"
                    log(msg)


# Phase 5h: sizes where the motion kernel (#16, #17) branches -- the smallest
# frames, widths on either side of a 16-byte chunk (16 u8, 8 u16, 4 int32
# samples) and of a warp's row segment (30 chunks), int32 luma codes at
# unaligned widths -- as (h, w, depth, luma type); and #4's chains: the 4K
# level 3, the 1440p level 2, 67x99 from level 0, and odd chains whose last
# (or every) level is below one 32x32 tile, as (h, w, levels, B).
MOTION_EDGE_SIZES = (
    (3, 3, 8, np.uint8), (5, 17, 8, np.uint8), (4, 15, 8, np.uint8), (4, 16, 8, np.uint8),
    (4, 17, 8, np.uint8), (6, 479, 8, np.uint8), (6, 481, 8, np.uint8), (67, 99, 8, np.uint8),
    (5, 7, 10, np.uint16), (5, 9, 10, np.uint16), (5, 239, 10, np.uint16), (5, 241, 10, np.uint16),
    (9, 31, 16, np.uint16), (7, 33, 10, np.int32), (7, 121, 16, np.int32), (35, 131, 12, np.int32),
    # Whole, aligned 16-byte chunks of u16 and int32 rows (the wide loads
    # and stores and the row-end mirror from the lane's own columns): one
    # chunk, two, one segment and two segments.
    (5, 8, 10, np.uint16), (6, 16, 16, np.uint16), (5, 240, 10, np.uint16), (9, 480, 16, np.uint16),
    (4, 8, 16, np.uint16), (7, 16, 10, np.uint16), (6, 240, 16, np.uint16), (5, 480, 10, np.uint16),
    (5, 4, 10, np.int32), (6, 120, 16, np.int32), (9, 124, 10, np.int32),
    (6, 4, 16, np.int32), (5, 120, 10, np.int32), (7, 124, 16, np.int32),
)
TAIL_CHAINS = ((270, 480, 3, 4), (360, 640, 4, 2), (67, 99, 5, 2), (40, 50, 3, 2), (23, 29, 3, 3),
               (17, 45, 3, 2))


def check_motion_tail_edges(dev, taps, opsin) -> None:
    """Phase 5h: #16 and #17 against their twins bit for bit at
    MOTION_EDGE_SIZES on two batches of three frames, the second batch's
    frame 0 taking the first's last blurred frame across the batch boundary
    (u16 and int32 luma at 10 and 16 bits too); #4 on TAIL_CHAINS against its
    twin (sums rtol 1e-4 / atol 1e-5) and bit for bit against kernel 2 on
    the same plane."""
    from turbo_metrics_tpu_torch.ops.kernels import fused_tail, motion, scale_tail

    rng = np.random.default_rng(1617)
    for h, w, depth, dt in MOTION_EDGE_SIZES:
        y = torch.from_numpy(rng.integers(0, 1 << depth, (6, h, w)).astype(dt)).to(dev)
        prev0 = torch.from_numpy(rng.integers(0, 1 << 16, (h, w)).astype(np.uint16)).to(dev)
        for b0 in (0, 3):
            batch = y[b0:b0 + 3]
            got = motion.motion_stats(batch, prev0, depth=depth)
            want = motion.motion_stats_ref(batch, prev0, depth=depth)
            blur = motion.integer_blur(batch, depth=depth)
            need(torch.equal(got["blurred"].to(torch.int32), want["blurred"].to(torch.int32))
                 and torch.equal(got["sad_rows"], want["sad_rows"]),
                 f"#16 differs from its twin at {h}x{w} {np.dtype(dt).name} {depth}-bit, frames {b0}+")
            need(torch.equal(blur.to(torch.int32), want["blurred"].to(torch.int32)),
                 f"#17 differs from the twin at {h}x{w} {np.dtype(dt).name} {depth}-bit")
            prev0 = want["blurred"][-1].contiguous()
    log(f"#16/#17 vs twins bit for bit at {len(MOTION_EDGE_SIZES)} edge sizes (u8, u16, int32; 8-16 bits), "
        "across the batch boundary")
    g = torch.Generator(device=dev).manual_seed(4)
    for h, w, levels, bsz in TAIL_CHAINS:
        p = torch.rand((2, bsz, 3, h, w), generator=g, device=dev)
        k4 = fused_tail.fused_tail(p, levels, taps, opsin)
        err = check_close(f"#4 vs twin, {levels} levels from {h}x{w}", k4,
                          fused_tail.fused_tail_ref(p, levels, taps, opsin), 1e-4, 1e-5)
        k2 = scale_tail.fused_pyramid_tail(p, levels, taps, opsin)
        need(torch.equal(k4, k2), f"#4 and kernel 2 differ on {levels} levels from {h}x{w}: max abs diff "
             f"{float((k4 - k2).abs().max()):.3g}")
        log(f"#4 on {levels} levels from {h}x{w} B={bsz}: max abs err vs twin {err:.3g}; sums equal to "
            "kernel 2's")


def check_xpsnr_convert_edges(dev) -> None:
    """Phase 5i: #13 against its twin bit for bit at XPSNR_EDGE_CASES, on two
    batches of three frames (the second batch's frame 0 taking the first's
    last reference as its previous frame); #5 (4:4:4 and 4:2:0) and #6
    against their twins at the threshold code values of every depth and
    range, with neutral chroma and Cb and Cr one code off it, for every
    transfer (atol 1e-6, 1e-4 for PQ), and on luma planes one sample past
    their storage's start (tools/edge_cases.py holds the sizes and codes)."""
    from turbo_metrics_tpu_torch.ops import colorspace
    from turbo_metrics_tpu_torch.ops.kernels import convert, xpsnr
    from turbo_metrics_tpu_torch.tools.edge_cases import XPSNR_EDGE_CASES, XPSNR_LUMA, threshold_codes

    rng = np.random.default_rng(1113)
    for h, w, ref_type, dis_type in XPSNR_EDGE_CASES:
        (ref_dt, ref_depth), (dis_dt, dis_depth) = XPSNR_LUMA[ref_type], XPSNR_LUMA[dis_type]
        ref = torch.from_numpy(rng.integers(0, 1 << ref_depth, (6, h, w)).astype(ref_dt)).to(dev)
        dis = torch.from_numpy(rng.integers(0, 1 << dis_depth, (6, h, w)).astype(dis_dt)).to(dev)
        prev0 = torch.from_numpy(rng.integers(0, 1 << ref_depth, (h, w)).astype(ref_dt)).to(dev)
        kw = dict(dis_shift=ref_depth - dis_depth)
        for b0 in (0, 3):
            args = (ref[b0:b0 + 3], dis[b0:b0 + 3], prev0 if b0 == 0 else ref[b0 - 1])
            got, want = xpsnr.xpsnr_block_stats(*args, **kw), xpsnr.xpsnr_block_stats_ref(*args, **kw)
            for k in want:
                need(torch.equal(got[k], want[k]),
                     f"#13 {k} differs from the twin's at {h}x{w} {ref_type}/{dis_type}, frames {b0}+")
        log(f"#13 vs twin at {h}x{w}, reference {ref_type}, distorted {dis_type}, two batches of 3: "
            "all grids equal")
    for depth in (8, 10, 16):
        dt = np.uint8 if depth == 8 else np.uint16
        for full in (False, True):
            codes = threshold_codes(depth, full)
            neutral = colorspace.sample_range(depth, full).neutral
            cb = np.array([neutral, neutral + 1, neutral - 1])[:, None]
            # 4:4:4: one row per chroma offset; 4:2:0: two luma rows per chroma row.
            y444 = torch.from_numpy(np.broadcast_to(codes, (3, codes.size)).astype(dt)[None].copy()).to(dev)
            uv444 = torch.from_numpy(np.stack([cb.repeat(codes.size, 1), cb[::-1].repeat(codes.size, 1)],
                                              -1).astype(dt)[None]).to(dev)
            y420 = torch.from_numpy(np.broadcast_to(codes, (2, 1, 6, codes.size)).astype(dt).copy()).to(dev)
            cw = (codes.size + 1) // 2
            uv420 = torch.from_numpy(np.broadcast_to(
                np.stack([cb.repeat(cw, 1), cb[::-1].repeat(cw, 1)], -1), (2, 1, 3, cw, 2)).astype(dt).copy()).to(dev)
            for transfer in ("bt709", "srgb", "pq", "hlg", "linear"):
                tol = 1e-4 if transfer == "pq" else 1e-6
                kw = dict(depth=depth, transfer=transfer, full_range=full)
                e444 = check_close(f"#5 4:4:4 {depth}-bit full={full} {transfer} at the threshold codes",
                                   convert.yuv_to_linear_rgb(y444, uv444, chroma=444, **kw),
                                   convert.yuv_to_linear_rgb_ref(y444, uv444, chroma=444, **kw), 0.0, tol)
                e420 = check_close(f"#5 4:2:0 {depth}-bit full={full} {transfer} at the threshold codes",
                                   convert.yuv_to_linear_rgb(y420, uv420, chroma=420, **kw),
                                   convert.yuv_to_linear_rgb_ref(y420, uv420, chroma=420, **kw), 0.0, tol)
                e6 = check_close(f"#6 {depth}-bit full={full} {transfer} at the threshold codes",
                                 convert.yuv420_to_linear_rgb_pair(y420, uv420, **kw),
                                 convert.yuv420_to_linear_rgb_pair_ref(y420, uv420, **kw), 0.0, tol)
                log(f"#5/#6 vs twins at the {codes.size} threshold codes, {depth}-bit full={full} {transfer}: "
                    f"max abs err #5 4:4:4 {e444:.3g}, #5 4:2:0 {e420:.3g}, #6 {e6:.3g}")
    # Luma planes one sample past their storage's start (a view): the paired
    # luma loads and float2 stores of a row are taken only where the bases
    # are aligned for them.
    h, w = 6, 34
    for depth in (8, 10):
        dt = np.uint8 if depth == 8 else np.uint16
        for chroma in (420, 422):
            ch = h // 2 if chroma == 420 else h
            y = torch.from_numpy(rng.integers(0, 1 << depth, 2 * h * w + 1).astype(dt)).to(dev)[1:].view(2, h, w)
            uv = torch.from_numpy(rng.integers(0, 1 << depth, (2, ch, w // 2, 2)).astype(dt)).to(dev)
            kw = dict(depth=depth, transfer="bt709")
            errs = [check_close(f"#5 {chroma} {depth}-bit on a luma view at storage offset 1",
                                convert.yuv_to_linear_rgb(y, uv, chroma=chroma, **kw),
                                convert.yuv_to_linear_rgb_ref(y, uv, chroma=chroma, **kw), 0.0, 1e-6)]
            if chroma == 420:
                y6, uv6 = y.view(2, 1, h, w), uv.view(2, 1, ch, w // 2, 2)
                errs.append(check_close(f"#6 {depth}-bit on a luma view at storage offset 1",
                                        convert.yuv420_to_linear_rgb_pair(y6, uv6, **kw),
                                        convert.yuv420_to_linear_rgb_pair_ref(y6, uv6, **kw), 0.0, 1e-6))
            log(f"#5{'/#6' if chroma == 420 else ''} vs twin{'s' if chroma == 420 else ''} at {h}x{w} "
                f"{chroma} {depth}-bit, luma at storage offset 1: max abs err "
                + ", ".join(f"{e:.3g}" for e in errs))


def sm_clock_mhz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm), MHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout.split()
    need(bool(out), "nvidia-smi gave no clocks.max.sm")
    return float(out[0])


def conversion_sass(card: str) -> dict:
    """Phase 2: the SASS counts of CONVERSION_SASS's kernels in the built
    library (tools/sass_count.py): {wrapper: (instructions per thread on the
    common path, MUFU among them, pixels per thread)}."""
    from turbo_metrics_tpu_torch.tools import sass_count

    rows = {r["kernel"]: r for r in sass_count.kernel_counts([k for k, _ in CONVERSION_SASS.values()])}
    counts = {}
    for wrapper, (kernel, ppt) in CONVERSION_SASS.items():
        need(kernel in rows, f"no SASS of {kernel} in the built library (have {sorted(rows)})")
        r = rows[kernel]
        counts[wrapper] = (r["path"], r["mufu"], ppt)
        log(f"SASS {kernel}: {r['path']} instructions per thread on the common path ({r['path'] / ppt:.1f} per "
            f"pixel), {r['mufu']} MUFU ({r['mufu'] / ppt:.2f} per pixel), {r['static']} in the function [{card}]")
    return counts


def integer_sass(card: str) -> None:
    """Phase 2: the SASS of INT_SASS's kernels in the built library
    (tools/sass_count.py): IMAD, IADD3, LDS and FFMA on a thread's common path,
    per thread and per output pixel."""
    from turbo_metrics_tpu_torch.tools import sass_count

    rows = {r["kernel"]: r for r in sass_count.kernel_counts([k for k, _ in INT_SASS.values()])}
    for wrapper, (kernel, ppt) in INT_SASS.items():
        need(kernel in rows, f"no SASS of {kernel} in the built library (have {sorted(rows)})")
        r = rows[kernel]
        per = ", ".join(f"{r['ops'][op]} {op} ({r['ops'][op] / ppt:.1f} per pixel)" for op in sass_count.OPS)
        log(f"SASS {kernel} ({wrapper}): {r['path']} instructions per thread on the common path "
            f"({r['path'] / ppt:.1f} per output pixel): {per}; {r['static']} in the function [{card}]")


def probe_sass(card: str) -> None:
    """Phase 2: the FFMA and LDS of blur_probe_kernel (#19) per output of one
    repetition, from its SASS (tools/sass_count.py).  The row-pass tasks are
    unrolled, so a thread's common path is one repetition of the threads
    that take a halo task too; its outputs are its column pass's, 8 rows x 4
    columns (csrc/blur_probe.cu).  Fewer than 22 FFMA per output would mean
    that the compiler dropped multiply-adds of a repetition."""
    from turbo_metrics_tpu_torch.tools import sass_count

    rows = sass_count.kernel_counts(["blur_probe_kernel"])
    need(len(rows) == 1, f"no single SASS of blur_probe_kernel in the built library (have {rows})")
    r = rows[0]
    per = 8 * 4
    ffma, lds = r["ops"]["FFMA"] / per, r["ops"]["LDS"] / per
    log(f"SASS blur_probe_kernel: {r['path']} instructions on a thread's path ({r['path'] / per:.2f} per output), "
        f"{r['ops']['FFMA']} FFMA ({ffma:.2f} per output), {r['ops']['LDS']} LDS ({lds:.2f} per output) of one "
        f"repetition, {per} outputs per thread; {r['static']} in the function [{card}]")
    need(ffma >= 22, f"blur_probe_kernel: {ffma:.2f} FFMA per output of a repetition, fewer than 22")


def issue_ms(counts, threads: int, dev) -> float:
    """The least time of ``threads`` threads each issuing the SASS of
    ``counts`` (path, mufu, _): its instructions over 128 lanes per SM and
    clock, its MUFU over 16, whichever takes longer, at the card's highest
    SM clock."""
    from turbo_metrics_tpu_torch.tools.sass_count import ISSUE_LANES_PER_SM, MUFU_LANES_PER_SM

    path, mufu, _ = counts
    rate = torch.cuda.get_device_properties(dev).multi_processor_count * sm_clock_mhz() * 1e6
    return max(path * threads / (rate * ISSUE_LANES_PER_SM), mufu * threads / (rate * MUFU_LANES_PER_SM)) * 1e3


def check_golden(dev) -> float:
    """Phase 6: the frozen golden pair through the kernel route."""
    from turbo_metrics_tpu_torch.models.ssimulacra2 import Ssimulacra2

    g_ref, g_dis = golden_pair()
    golden = Ssimulacra2(160, 120, device=dev).score_pair(g_ref, g_dis)
    need(abs(golden - GOLDEN) <= 0.05, f"golden pair {golden} vs {GOLDEN}")
    log(f"golden pair: {golden:.6f} (frozen {GOLDEN}, budget 0.05)")
    return golden


def run_uhd_path(ref_path: str, dis_path: str, dev, card: str):
    """Phase 4f: the 3840x2160 pair with -m ssimulacra2 through the CLI: two
    batches of 4, each kernel 1, #3 on levels 1 and 2, #4 on levels 3-5."""
    scores, launches, seconds = run_cli(ref_path, dis_path, dev, ["ssimulacra2"], frames=UHD_FRAMES)
    log(f"CLI (f) {UHD_WIDTH}x{UHD_HEIGHT} -m ssimulacra2: {UHD_FRAMES} frames in {seconds:.2f} s "
        f"(first call and decode included), launches {launches} [{card}]")
    log(f"CLI (f) scores: {scores['ssimulacra2'].tolist()}")
    batches = UHD_FRAMES // UHD_BATCH
    want = {"fused_scale0_yuv": batches, "fused_scale_rgb": 2 * batches, "fused_tail": batches,
            "fused_pyramid_tail": 0}
    got = {k: launches[k] for k in want}
    need(got == want, f"(f): launches {got}, want {want}")
    return scores["ssimulacra2"], launches


# Phase 4g: the committed compressed pair (tests/torch_io_clips.py made it
# and its record, clips.json, with the JAX package on the CPU).
CLIPS = os.path.join("turbo_metrics_tpu_torch", "tools", "clips")


def decoding_tools() -> dict:
    """Phase 4g's explicit probe, before any decode: what this machine has
    for the native shim (compiler, pkg-config, libav's shared objects; then
    the shim's build or load, which decodes nothing), Pillow and cv2."""
    from turbo_metrics_tpu_torch.io import native

    have = native.libav_probe()
    t0 = time.monotonic()
    have["shim_error"] = native.SHIM.error()
    have["shim_seconds"] = time.monotonic() - t0
    have["shim_path"] = str(native.SHIM.path)
    have["shim_built"] = native.SHIM.built
    for mod in ("PIL", "cv2"):
        try:
            have[mod] = __import__(mod).__version__
        except ImportError:
            have[mod] = None
    return have


def decode_all(src) -> tuple:
    """Every frame of a source, and the host ms per frame of the decode."""
    t0 = time.perf_counter()
    frames = []
    while (f := src.get_frame()) is not None:
        frames.append(f)
    src.close()
    return frames, (time.perf_counter() - t0) * 1e3 / max(len(frames), 1)


def sha256(a) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def write_y4m_frames(path: str, frames) -> None:
    """8-bit 4:2:0 decoded frames as Y4M (no colour tags: the same height
    fallback and limited range as the native source's)."""
    h, w = frames[0].y.shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C420\n".encode())
        for fr in frames:
            f.write(b"FRAME\n" + fr.y.tobytes() + np.ascontiguousarray(fr.uv[..., 0]).tobytes()
                    + np.ascontiguousarray(fr.uv[..., 1]).tobytes())


def run_compressed_path(dev, card: str, tmp: str, y4m_pair):
    """Phase 4g: the committed VP9 MKV / MPEG-2 TS pair through the port's
    input layer and CLI.  Returns the warm runs to time in phase 7 (the
    compressed pair beside a Y4M pair)."""
    from turbo_metrics_tpu_torch.io import native, probe

    with open(os.path.join(CLIPS, "clips.json")) as f:
        record = json.load(f)
    ref, dis = (os.path.join(CLIPS, record[k]) for k in ("reference", "distorted"))
    have = decoding_tools()
    log(f"decoding on this machine: g++ {have['compiler']}; pkg-config libav {have['pkg_config']}; "
        f"shared objects {have['shared_objects']}; missing {have['missing']}; Pillow {have['PIL']}; "
        f"cv2 {have['cv2']} [{card}]")
    if have["PIL"] is not None:
        run_image_pair(dev, card, tmp)
    else:
        log("no Pillow: the image input path is not checked on this machine")
    if have["shim_error"] is None:
        log(f"native shim: {have['shim_path']} {'built' if have['shim_built'] else 'loaded'} in "
            f"{have['shim_seconds']:.2f} s")
        return run_native_clips(dev, card, tmp, record, ref, dis)
    log(f"native shim: unavailable: {have['shim_error']}")
    # The explicit probe found no usable libav: compressed decoding through
    # the shim is not checked on this machine, and the port's error says why.
    err = None
    try:
        native.NativeVideoSource(ref).close()
    except RuntimeError as e:
        err = str(e)
    need(err is not None, "NativeVideoSource opened a clip though the shim is unavailable")
    need("native demuxer unavailable" in err and all(n in err for n in have["missing"]),
         f"the port's error does not name the missing libraries {have['missing']}: {err}")
    log(f"compressed decoding through the native shim NOT checked on this card ({card}): "
        f"the shim does not build here (libav missing: {', '.join(have['missing']) or 'development files'}); "
        f"NativeVideoSource raises: {err}")
    if have["cv2"] is None:
        err = None
        try:
            probe.create_source(ref).close()
        except RuntimeError as e:
            err = str(e)
        need(err is not None and "vp9" in err and "1920x1080" in err,
             f"the probe's error does not name the stream: {err}")
        log(f"no OpenCV either: create_source raises {err}")
        return {}
    return run_opencv_clips(dev, card, record, ref, dis, y4m_pair)


def run_image_pair(dev, card: str, tmp: str) -> None:
    """Phase 4g, images: the golden pair's 8-bit sRGB images as PNG files
    through the CLI (Pillow, the engine's RGB route): the golden score."""
    from PIL import Image

    paths = [os.path.join(tmp, n) for n in ("golden_ref.png", "golden_dis.png")]
    for path, img in zip(paths, golden_pair_u8()):
        Image.fromarray(img).save(path)
    scores, launches, _ = run_cli(*paths, dev, ["ssimulacra2"], frames=1)
    score = float(scores["ssimulacra2"][0])
    log(f"CLI (g) PNG golden pair: {score:.6f} (frozen {GOLDEN}, budget 0.05), launches "
        f"{ {k: v for k, v in launches.items() if v} } [{card}]")
    need(abs(score - GOLDEN) <= 0.05, f"(g) PNG golden pair {score} vs {GOLDEN}")
    need(launches["fused_scale_srgb"] > 0 and launches["fused_scale_rgb"] == 0,
         f"(g) the PNG pair did not take the sRGB conversion pass alone: {launches}")


def run_native_clips(dev, card: str, tmp: str, record: dict, ref: str, dis: str):
    """Phase 4g where the shim builds or loads: decoded planes against the
    record's hashes, the CLI against the JAX package's CPU scores, with
    --decode-workers 2 and on Y4M files of the decoded frames."""
    from turbo_metrics_tpu_torch.io import native

    decoded = {}
    for path in (ref, dis):
        rec = record["clips"][os.path.basename(path)]["native"]
        frames, _ = decode_all(native.NativeVideoSource(path))
        planes = [[sha256(f.y), sha256(f.uv[..., 0]), sha256(f.uv[..., 1])] for f in frames]
        need(planes == rec["planes_sha256"],
             f"{path}: decoded planes differ from the record in frames "
             f"{[i for i, (a, b) in enumerate(zip(planes, rec['planes_sha256'])) if a != b]} "
             f"({len(planes)} frames, {len(rec['planes_sha256'])} recorded)")
        _, ms = decode_all(native.NativeVideoSource(path))
        log(f"{rec['format']}: {len(frames)} frames {frames[0].y.shape[1]}x{frames[0].y.shape[0]}, planes equal "
            f"to the record; native decode {ms:.2f} ms per frame (host clock, warm) [{card}]")
        decoded[path] = frames
    want = np.asarray(record["ssimulacra2_jax_cpu"]["native"])
    scores, launches, seconds = run_cli(ref, dis, dev, ["ssimulacra2"])
    s2 = scores["ssimulacra2"]
    log(f"CLI (g) VP9 MKV vs MPEG-2 TS -m ssimulacra2: {FRAMES} frames in {seconds:.2f} s, launches "
        f"{launches} [{card}]")
    need(launches["fused_scale0_yuv"] > 0 and launches["fused_pyramid_tail"] > 0,
         f"(g): a kernel of the SSIMULACRA2 route was not launched: {launches}")
    d = float(np.abs(s2 - want).max())
    log(f"CLI (g) scores {s2.tolist()}; max |diff| vs the JAX package on the CPU {d:.3g}")
    need(d <= 0.01, f"(g) scores apart from the JAX package's by {d}")
    pooled, _, _ = run_cli(ref, dis, dev, ["ssimulacra2"], extra=("--decode-workers", "2"))
    need(np.array_equal(pooled["ssimulacra2"], s2), "(g) --decode-workers 2 changed the scores")
    y4m = [os.path.join(tmp, n) for n in ("clip_ref.y4m", "clip_dis.y4m")]
    for path, frames in zip(y4m, (decoded[ref], decoded[dis])):
        write_y4m_frames(path, frames)
    again, _, _ = run_cli(*y4m, dev, ["ssimulacra2"])
    need(np.array_equal(again["ssimulacra2"], s2), "(g) Y4M of the decoded frames scored differently")
    log("(g) --decode-workers 2 and the Y4M of the decoded frames: scores bit-equal")
    return {"(g) VP9 MKV vs MPEG-2 TS, native shim": (ref, dis, ["ssimulacra2"], FRAMES, ()),
            "(g) Y4M of the same decoded frames": (*y4m, ["ssimulacra2"], FRAMES, ())}


def run_opencv_clips(dev, card: str, record: dict, ref: str, dis: str, y4m_pair):
    """Phase 4g where the shim is unavailable and cv2 present: the JAX
    package's fallback, OpenCV (8-bit RGB frames, the engine's sRGB route:
    the sRGB conversion pass, the level chain)."""
    from turbo_metrics_tpu_torch.engine import Metrics, TurboMetrics
    from turbo_metrics_tpu_torch.io import opencv_source, probe
    from turbo_metrics_tpu_torch.models.ssimulacra2 import Ssimulacra2, ssimulacra2_subscores
    from turbo_metrics_tpu_torch.ops import colorspace

    for path in (ref, dis):
        src = probe.create_source(path)
        need(isinstance(src, opencv_source.OpenCvVideoSource),
             f"{path}: the probe took {type(src).__name__}, not the OpenCV fallback")
        src.close()
    decoded, same = {}, {}
    for path in (ref, dis):
        rec = record["clips"][os.path.basename(path)]["opencv"]
        frames, _ = decode_all(opencv_source.OpenCvVideoSource(path))
        need(len(frames) == FRAMES, f"{path}: OpenCV decoded {len(frames)} frames")
        _, ms = decode_all(opencv_source.OpenCvVideoSource(path))
        hashes = [sha256(f.rgb) for f in frames]
        same[path] = hashes == rec["rgb_sha256"]
        log(f"{os.path.basename(path)}: OpenCV decode {ms:.2f} ms per frame (host clock, warm; 8-bit RGB); "
            f"frames {'equal to' if same[path] else 'NOT equal to'} the record's (cv2 {rec['cv2']}) in "
            f"{sum(a == b for a, b in zip(hashes, rec['rgb_sha256']))} of {FRAMES} [{card}]")
        decoded[path] = frames
    scores, launches, seconds = run_cli(ref, dis, dev, ["ssimulacra2"])
    s2 = scores["ssimulacra2"]
    log(f"CLI (g) VP9 MKV vs MPEG-2 TS through OpenCV, -m ssimulacra2: {FRAMES} frames in {seconds:.2f} s, "
        f"launches {launches} [{card}]")
    need(launches["fused_scale_srgb"] > 0 and launches["fused_pyramid_tail"] > 0
         and launches["fused_scale_rgb"] == 0,
         f"(g): the sRGB route (its conversion pass, kernel 2; no #3) was not taken: {launches}")
    pooled, _, _ = run_cli(ref, dis, dev, ["ssimulacra2"], extra=("--decode-workers", "2"))
    need(np.array_equal(pooled["ssimulacra2"], s2), "(g) --decode-workers 2 changed the scores")
    # The same decoded frames through the engine directly, and through the
    # plain five-blur chain on the card.
    h, w = decoded[ref][0].rgb.shape[:2]
    engine = TurboMetrics(w, h, Metrics(ssimulacra2=True), batch=BATCH, device=dev)
    srgb = opencv_source.SRGB_CHARACTERISTICS, "full"
    model = Ssimulacra2(w, h, device=dev)
    direct, plain = [], []
    with torch.no_grad():
        for b in range(0, FRAMES, BATCH):
            fr, fd = decoded[ref][b:b + BATCH], decoded[dis][b:b + BATCH]
            direct += [s.ssimulacra2 for s in engine.compute_frames(fr, srgb, fd, srgb)]
            lin = [colorspace.srgb_to_linear(torch.from_numpy(np.stack([f.rgb for f in fs])).to(dev)
                                             .permute(0, 3, 1, 2), depth=8) for fs in (fr, fd)]
            plain += model.score(ssimulacra2_subscores(*lin, num_scales=model.num_scales)).tolist()
    need(np.array_equal(np.asarray(direct), s2), "(g) compute_frames on the decoded frames scored differently")
    d_plain = float(np.abs(np.asarray(plain) - s2).max())
    log(f"CLI (g) scores {s2.tolist()}; --decode-workers 2 (ignored: not the native shim) and compute_frames "
        f"on the decoded frames bit-equal; max |diff| vs the plain five-blur chain on the card {d_plain:.3g}")
    need(d_plain <= 0.01, f"(g) kernel route apart from the plain chain by {d_plain}")
    if all(same.values()):
        d = float(np.abs(s2 - np.asarray(record["ssimulacra2_jax_cpu"]["opencv"])).max())
        log(f"(g) max |diff| vs the JAX package on the CPU on the same OpenCV frames {d:.3g}")
        need(d <= 0.01, f"(g) scores apart from the JAX package's by {d}")
    else:
        log("(g) this card's cv2 decodes other RGB frames than the record's: no comparison with the JAX "
            "package's scores")
    return {"(g) VP9 MKV vs MPEG-2 TS, OpenCV": (ref, dis, ["ssimulacra2"], FRAMES, ()),
            "(g) the Y4M pair of phase 3": (*y4m_pair, ["ssimulacra2"], FRAMES, ())}


def plain_level(lin, levels: int):
    """The plain 2x2-mean chain: level ``levels`` of a (2, B, 3, h, w) pair."""
    from turbo_metrics_tpu_torch.ops.downscale import downscale_by_2

    for _ in range(levels):
        lin = downscale_by_2(lin)
    return lin.contiguous()


def uhd_step_kernel(y2, uv2, model):
    from turbo_metrics_tpu_torch.models.ssimulacra2 import ssimulacra2_subscores_from_yuv

    return ssimulacra2_subscores_from_yuv(y2, uv2, model.taps, model.opsin, num_scales=model.num_scales)


def uhd_step_kernel2(y2, uv2, model):
    """The 4K step by the route the port ran before the level chain:
    kernel 1, then kernel 2 on levels 1-5 (timed beside ``uhd_step_kernel``)."""
    from turbo_metrics_tpu_torch.models.ssimulacra2 import subscores_from_sums
    from turbo_metrics_tpu_torch.ops.kernels import scale_stats, scale_tail

    taps, opsin = model.taps, model.opsin
    sums0, l1 = scale_stats.fused_scale0_yuv(y2, uv2, taps, opsin)
    rest = scale_tail.fused_pyramid_tail(l1, model.num_scales - 1, taps, opsin)
    return subscores_from_sums([sums0] + list(rest.unbind(1)), model.dims)


def uhd_step_plain(y2, uv2, model):
    """The 4K step through the twins in the kernels' route: kernel 1's, #3's
    on levels 1 and 2, #4's on levels 3-5."""
    from turbo_metrics_tpu_torch.models.ssimulacra2 import subscores_from_sums
    from turbo_metrics_tpu_torch.ops.kernels import fused_tail, scale_stats

    taps, opsin = model.taps, model.opsin
    sums = []
    s, lvl = scale_stats.fused_scale0_yuv_ref(y2, uv2, taps, opsin)
    sums.append(s)
    for _ in range(2):
        s, lvl = scale_stats.fused_scale_rgb_ref(lvl, taps, opsin)
        sums.append(s)
    sums += list(fused_tail.fused_tail_ref(lvl, model.num_scales - 3, taps, opsin).unbind(1))
    return subscores_from_sums(sums, model.dims)


def check_uhd(y2, uv2, model, cli_scores, dev):
    """Phase 5d: kernel #4 against its twin and kernel 2 on the 4K pair's
    level 3, on a 67x99 pair from level 0 and on the 2560x1440 route; the 4K
    kernel step against the twins, the five-blur plain chain and the CLI.
    Returns (#4's max abs error, the level-3 plane)."""
    from turbo_metrics_tpu_torch.models.ssimulacra2 import (
        Ssimulacra2,
        level_route,
        ssimulacra2_subscores,
        ssimulacra2_subscores_from_yuv,
        subscores_from_sums,
    )
    from turbo_metrics_tpu_torch.ops import colorspace
    from turbo_metrics_tpu_torch.ops.downscale import scale_dims
    from turbo_metrics_tpu_torch.ops.kernels import fused_tail, scale_stats, scale_tail

    taps, opsin, dims = model.taps, model.opsin, model.dims
    norms = scale_stats.norms_from_sums
    lin = colorspace.yuv420_to_linear_rgb(y2, uv2, backend="jnp")
    lvl3 = plain_level(lin, 3)
    k4 = fused_tail.fused_tail(lvl3, 3, taps, opsin)
    p4 = fused_tail.fused_tail_ref(lvl3, 3, taps, opsin)
    k2 = scale_tail.fused_pyramid_tail(lvl3, 3, taps, opsin)
    e4 = max(check_close(f"#4 level {i + 3} norms", norms(k4[:, i], h * w), norms(p4[:, i], h * w), 1e-4, 1e-5)
             for i, (h, w) in enumerate(dims[3:]))
    check_close("#4 vs its twin, sums", k4, p4, 1e-4, 1e-5)
    need(torch.equal(k4, k2), f"#4 and kernel 2 differ on the 4K level 3: max abs diff "
         f"{float((k4 - k2).abs().max()):.3g}")
    need(torch.equal(k4, fused_tail.fused_tail(lvl3, 3, taps, opsin)), "#4 differs between two runs")
    log(f"#4 vs twin at {tuple(lvl3.shape)}: max abs err {e4:.3g} (norms); sums equal to kernel 2's")

    reset_counts()
    sub_k = uhd_step_kernel(y2, uv2, model)
    got = {k: v for k, v in read_counts().items() if v}
    want = {"fused_scale0_yuv": 1, "fused_scale_rgb": 2, "fused_tail": 1}
    need(got == want, f"4K kernel step launches {got}, want {want}")
    sub_p = uhd_step_plain(y2, uv2, model)
    e_step = check_close("4K kernel step sub-scores", sub_k, sub_p, 1e-4, 1e-5)
    sub_chain = ssimulacra2_subscores(lin[0], lin[1], num_scales=model.num_scales)
    sc_k, sc_p, sc_c = (model.score(s) for s in (sub_k, sub_p, sub_chain))
    d_plain, d_chain = float(np.abs(sc_k - sc_p).max()), float(np.abs(sc_k - sc_c).max())
    d_cli = float(np.abs(sc_k - np.asarray(cli_scores[:UHD_BATCH])).max())
    log(f"4K kernel step scores {sc_k.tolist()}; sub-scores vs twins max abs err {e_step:.3g}; max |score "
        f"diff| vs twins {d_plain:.3g}, vs five-blur plain chain {d_chain:.3g}, vs CLI {d_cli:.3g}")
    need(d_plain <= 0.01 and d_chain <= 0.01 and d_cli <= 0.01,
         f"4K scores apart: vs twins {d_plain}, vs five-blur chain {d_chain}, vs CLI {d_cli}")
    del lin, sub_chain

    g = torch.Generator(device=dev).manual_seed(4)
    small = torch.rand((2, 2, 3, 67, 99), generator=g, device=dev)
    ks, ps = fused_tail.fused_tail(small, 5, taps, opsin), fused_tail.fused_tail_ref(small, 5, taps, opsin)
    e_small = max(check_close(f"#4 67x99 level {i} norms", norms(ks[:, i], h * w), norms(ps[:, i], h * w),
                              1e-4, 1e-5)
                  for i, (h, w) in enumerate(scale_dims(67, 99)))
    need(torch.equal(ks, scale_tail.fused_pyramid_tail(small, 5, taps, opsin)),
         "#4 and kernel 2 differ on the 67x99 pair")
    log(f"#4 vs twin on 67x99 from level 0, five levels: max abs err {e_small:.3g}; sums equal to kernel 2's")

    h, w, n = 1440, 2560, 2
    m1440 = Ssimulacra2(w, h, device=dev)
    need(level_route((h + 1) // 2, (w + 1) // 2, m1440.num_scales, 1)
         == [("fused_scale_rgb", (1,)), ("fused_tail", (2, 3, 4, 5))], "the 1440p route changed")
    rng = np.random.default_rng(1440)
    yq = torch.from_numpy(rng.integers(16, 236, (2, n, h, w)).astype(np.uint8)).to(dev)
    uvq = torch.from_numpy(rng.integers(16, 241, (2, n, h // 2, w // 2, 2)).astype(np.uint8)).to(dev)
    reset_counts()
    sub_k = ssimulacra2_subscores_from_yuv(yq, uvq, taps, opsin, num_scales=m1440.num_scales)
    got = {k: v for k, v in read_counts().items() if v}
    want = {"fused_scale0_yuv": 1, "fused_scale_rgb": 1, "fused_tail": 1}
    need(got == want, f"1440p route launches {got}, want {want}")
    s0, l1 = scale_stats.fused_scale0_yuv_ref(yq, uvq, taps, opsin)
    s1, l2 = scale_stats.fused_scale_rgb_ref(l1, taps, opsin)
    rest = fused_tail.fused_tail_ref(l2, 4, taps, opsin)
    e1440 = check_close("1440p route sub-scores", sub_k,
                        subscores_from_sums([s0, s1] + list(rest.unbind(1)), m1440.dims), 1e-4, 1e-5)
    log(f"1440p route (kernel 1, #3, #4 on levels 2-5) vs twins: sub-scores max abs err {e1440:.3g}")
    return e4, lvl3


def check_backends(y2, uv2, model, dev):
    """Phase 5e: the legacy backends at 1080p B=8, counters reset around each
    run, against the plain chain; #7, #8 and #10 against their twins; the
    jnp_iir backend on the golden pair.  Returns (launches by backend, max
    abs errors by kernel, the linear-RGB pair, its XYB pair)."""
    from turbo_metrics_tpu_torch.models.ssimulacra2 import (
        Ssimulacra2,
        ssimulacra2_subscores,
        subscores_from_sums,
    )
    from turbo_metrics_tpu_torch.ops import colorspace
    from turbo_metrics_tpu_torch.ops.kernels import downscale, scale_stats, scale_tail
    from turbo_metrics_tpu_torch.ops.xyb import linear_rgb_to_xyb

    taps, opsin, dims, ns = model.taps, model.opsin, model.dims, model.num_scales
    lin = colorspace.yuv420_to_linear_rgb(y2, uv2, backend="jnp").contiguous()
    sums_p = scale_tail.fused_pyramid_tail_ref(lin, ns, taps, opsin)
    sub_p = subscores_from_sums(list(sums_p.unbind(1)), dims)
    sc_p = model.score(sub_p)
    sc_c = model.score(ssimulacra2_subscores(lin[0], lin[1], num_scales=ns))
    launches, err = {}, {}
    want = {"pallas": {"scale_sums": ns},
            "pallas2": {"fused_scale_pair": ns, "downscale_by_2": 2 * (ns - 1)},
            "pallas3": {"fused_scale_rgb": 1, "fused_pyramid_tail": 1}}
    for b, want_b in want.items():
        mb = Ssimulacra2(WIDTH, HEIGHT, backend=b, device=dev)
        reset_counts()
        sub = mb(lin[0], lin[1])
        launches[b] = read_counts()
        got = {k: v for k, v in launches[b].items() if v}
        need(got == want_b, f"backend {b}: launches {got}, want {want_b}")
        e = check_close(f"backend {b} sub-scores", sub, sub_p, 1e-4, 1e-5)
        sc = mb.score(sub)
        d_p, d_c = float(np.abs(sc - sc_p).max()), float(np.abs(sc - sc_c).max())
        log(f"Ssimulacra2(backend={b!r}) at {WIDTH}x{HEIGHT} B={BATCH}: launches {got}; sub-scores vs the "
            f"plain chain max abs err {e:.3g}; max |score diff| vs plain {d_p:.3g}, vs five-blur {d_c:.3g}")
        need(d_p <= 0.01 and d_c <= 0.01, f"backend {b}: scores apart by {d_p} / {d_c}")

    ds_k, ds_p = downscale.downscale_by_2(lin[0]), downscale.downscale_by_2_ref(lin[0])
    need(torch.equal(ds_k, ds_p), "#7 differs from its twin")
    odd = lin[0, :, :, :67, :99].contiguous()
    need(torch.equal(downscale.downscale_by_2(odd), downscale.downscale_by_2_ref(odd)),
         "#7 differs from its twin at 67x99")
    pool = torch.nn.functional.avg_pool2d(lin[0], 2, ceil_mode=True)
    pool_odd = torch.nn.functional.avg_pool2d(odd, 2, ceil_mode=True)
    log(f"#7 equal to its twin at {WIDTH}x{HEIGHT} B={BATCH} and at 67x99; avg_pool2d(2, ceil_mode) max abs "
        f"diff {float((pool - ds_p).abs().max()):.3g} (67x99: "
        f"{float((pool_odd - downscale.downscale_by_2_ref(odd)).abs().max()):.3g})")
    err["downscale_by_2"] = 0.0
    h, w = dims[0]
    norms = scale_stats.norms_from_sums
    xyb = [linear_rgb_to_xyb(lin[i], opsin=opsin).contiguous() for i in (0, 1)]
    err["scale_sums"] = check_close("#8 norms", norms(scale_stats.scale_sums(*xyb, taps), h * w),
                                    norms(scale_stats.level_sums_ref(*xyb, taps), h * w), 1e-4, 1e-5)
    err["fused_scale_pair"] = check_close(
        "#10 norms", norms(scale_stats.fused_scale_pair(lin[0], lin[1], taps, opsin), h * w),
        norms(scale_stats.fused_scale_pair_ref(lin[0], lin[1], taps, opsin), h * w), 1e-4, 1e-5)
    log(f"#8 vs twin: max abs err {err['scale_sums']:.3g}; #10 vs twin: {err['fused_scale_pair']:.3g} (norms)")

    g_ref, g_dis = golden_pair()
    iir = Ssimulacra2(160, 120, backend="jnp_iir", device=dev).score_pair(g_ref, g_dis)
    log(f"golden pair through jnp_iir: {iir:.6f} (frozen {GOLDEN}, budget 0.05)")
    need(abs(iir - GOLDEN) <= 0.05, f"jnp_iir golden pair {iir} vs {GOLDEN}")
    return launches, err, lin, xyb


def probe_input(dev):
    """The dissect tool's lin1: (4, 3, 1080, 1920) f32 uniform in [0, 1)
    from default_rng(0), as the JAX package's tools/kernel_dissect.py makes it."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.random((4, 3, HEIGHT, WIDTH), dtype=np.float64).astype(np.float32)).to(dev)


def check_blur_probe(lin1, taps) -> float:
    """Phase 5f: kernel #19 against its twin at the dissect tool's shape, on
    a plane inside one region tile and on planes across several (the bottom
    and right spill in both): totals rtol 1e-5, every other entry exactly 0.
    Returns the max abs error at the tool's shape."""
    from turbo_metrics_tpu_torch.ops.kernels import blur_probe

    g = torch.Generator(device=lin1.device).manual_seed(19)
    errs = []
    for name, x in (
        (f"B=4 {WIDTH}x{HEIGHT}", lin1),
        ("67x99", torch.rand((1, 3, 67, 99), generator=g, device=lin1.device)),
        ("300x700", torch.rand((2, 300, 700), generator=g, device=lin1.device)),
    ):
        got, want = blur_probe.blur_only(x, taps), blur_probe.blur_only_ref(x, taps)
        e = check_close(f"#19 totals at {name}", got[:, 0, 0], want[:, 0, 0], 1e-5, 0.0)
        rest = got.clone()
        rest[:, 0, 0] = 0
        need(not bool(rest.any()), f"#19 at {name}: an entry other than [p, 0, 0] is not 0")
        log(f"#19 vs twin at {name}: totals max abs err {e:.3g} (totals ~{float(want[:, 0, 0].mean()):.6g}), "
            "other entries 0")
        errs.append(e)
    return errs[0]


def conv_blur_sums(xp, taps, separable: bool, passes: int = 5):
    """#19's function by F.conv2d: ``passes`` blurs of the padded planes xp
    (P, 1, R, C), summed per plane; each blur one 11x11 convolution with the
    outer product of the taps, or (``separable``) a 1x11 then an 11x1 one,
    #19's own 22 multiply-adds per pixel.  Yardsticks only."""
    conv = torch.nn.functional.conv2d
    kr, kc = taps.reshape(1, 1, 1, 11), taps.reshape(1, 1, 11, 1)
    k2d = torch.outer(taps, taps).reshape(1, 1, 11, 11)

    def blur():
        if separable:
            return conv(conv(xp, kr, padding=(0, 5)), kc, padding=(5, 0))
        return conv(xp, k2d, padding=5)

    return sum(blur().sum(dim=(-2, -1)) for _ in range(passes))


def run_dissect_path(card: str):
    """Phase 8: the dissect tool at its default shape, every launch counter
    set to 0 just before and read just after.  Returns (its JSON object,
    launches)."""
    from turbo_metrics_tpu_torch.tools import kernel_dissect

    # Work that other threads of this process launch lands in the profiler's
    # readings too: name any that an earlier phase left running.
    others = [t.name for t in threading.enumerate() if t is not threading.current_thread()]
    log(f"dissect path: {len(others)} other threads alive {others} [{card}]")
    reset_counts()
    out = io.StringIO()
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(out):
            result = kernel_dissect.main([])
    finally:
        # The entries done before a failing one say which one failed.
        lines = out.getvalue().splitlines()
        for ln in lines if lines and not lines[-1].startswith("{") else lines[:-1]:
            log(f"dissect: {ln}")
    launches = read_counts()
    log(f"dissect path in {time.monotonic() - t0:.1f} s, launches {launches} [{card}]")
    need(all(launches[k] > 0 for k in DISSECT_KERNELS),
         f"a kernel of the dissect path was not launched: {launches}")
    rows = result["dissect"]
    need(rows and all(r["device_ms"] is not None and r["device_ms"] > 0 for r in rows),
         "the dissect tool recorded no device time for a kernel")
    return result, launches

# Phase 9: frame data parallelism (parallel/mesh.py, TurboMetrics(mesh=...)):
# two shards of card 0, each on its own stream.
MESH_SHARDS = 2
# Phase 9 (a)'s configurations: (name, Metrics flags, vmaf_integer, with the
# fixture fusion model).
MESH_CONFIGS = (
    ("all six, fixture model", dict(ssimulacra2=True, psnr=True, ssim=True, msssim=True, xpsnr=True, vmaf=True),
     False, True),
    ("--vmaf-integer, fixture model", dict(vmaf=True), True, True),
    ("SSIMULACRA2 alone", dict(ssimulacra2=True), False, False),
)


def mesh_bar(field: str) -> float:
    """tests/test_parallel.py's bars for a field that is not bit-equal to
    the unsharded engine's: motion exact, VIF, ADM and XPSNR 1e-9, the
    scores 1e-6."""
    if field == "vmaf_motion":
        return 0.0
    if field == "xpsnr" or field.startswith(("vmaf_vif", "vmaf_adm")):
        return 1e-9
    return 1e-6


def mesh_engine(flags: dict, integer: bool, fused: bool, dev, mesh=None):
    from turbo_metrics_tpu_torch.engine import Metrics, TurboMetrics
    from turbo_metrics_tpu_torch.models.vmaf_model import VmafModel

    return TurboMetrics(WIDTH, HEIGHT, Metrics(**flags), batch=BATCH, device=dev, vmaf_integer=integer,
                        vmaf_model=VmafModel.from_dict(FIXTURE_MODEL) if fused else None, mesh=mesh)


def engine_run(ref_path: str, dis_path: str, engine):
    """``engine.compute_all`` of the Y4M pair, every launch counter set to 0
    just before and read just after: (each frame's FrameScores as a dict,
    launches, host seconds)."""
    from turbo_metrics_tpu_torch.io.probe import create_source

    frames = []
    srcs = (create_source(ref_path), create_source(dis_path))
    reset_counts()
    t0 = time.monotonic()
    res = engine.compute_all(*srcs, on_frame=lambda s: frames.append(s.to_dict()))
    launches = read_counts()
    seconds = time.monotonic() - t0
    for src in srcs:
        src.close()
    need(res.frame_count == FRAMES and len(frames) == FRAMES, f"the engine scored {res.frame_count} frames")
    return frames, launches, seconds


def check_mesh_scores(what: str, got: list, want: list) -> None:
    """Every FrameScores field of the mesh engine against the unsharded
    engine's: bit for bit expected; a field that is not is logged with its
    largest difference and held to mesh_bar."""
    need(len(got) == len(want), f"(9) {what}: {len(got)} frames vs {len(want)}")
    diff = {}
    for i, (g, w) in enumerate(zip(got, want)):
        need(set(g) == set(w), f"(9) {what}: frame {i} has the fields {sorted(g)}, unsharded {sorted(w)}")
        for k, v in g.items():
            need(math.isfinite(v) or v == w[k], f"(9) {what}: frame {i} {k} = {v}")
            if v != w[k]:
                diff[k] = max(diff.get(k, 0.0), abs(v - w[k]))
    fields = sorted(got[0])
    if not diff:
        log(f"(9a) {what}: all {len(fields)} fields of {len(got)} frames bit-equal to the unsharded engine "
            f"({', '.join(fields)})")
    for k, d in diff.items():
        log(f"(9a) {what}: {k} NOT bit-equal to the unsharded engine, max |diff| {d:.3g} (bar {mesh_bar(k):g})")
        need(d <= mesh_bar(k), f"(9) {what}: {k} apart from the unsharded engine's by {d}")


def check_mesh_launches(what: str, got: dict, single: dict, shards: int) -> None:
    """Each wrapper launched by the mesh run once per shard where the
    unsharded run launched it once; #17 (integer_blur) once for the stream's
    first frame and once per batch for each shard after the first (its
    previous shard's last reference frame)."""
    batches = FRAMES // BATCH
    for k, u in single.items():
        want = 1 + batches * (shards - 1) if k == "integer_blur" and u else shards * u
        need(got[k] == want, f"(9) {what}: {k} launched {got[k]} times over {shards} shards, want {want} "
             f"(unsharded {u})")
    need(any(got.values()), f"(9) {what}: no kernel launched")


def run_mesh_configs(ref_path: str, dis_path: str, dev, mesh, card: str, label: str) -> dict:
    """Phase 9 (a) (and (c) over every card): each of MESH_CONFIGS through
    the unsharded engine and through the engine over ``mesh``, every field
    held.  Returns {config: (unsharded seconds, mesh seconds)}."""
    out = {}
    for name, flags, integer, fused in MESH_CONFIGS:
        want, single_launches, s1 = engine_run(ref_path, dis_path, mesh_engine(flags, integer, fused, dev))
        eng = mesh_engine(flags, integer, fused, dev, mesh)
        need(eng.batch == BATCH, f"(9) the mesh engine's batch is {eng.batch}")
        got, launches, s2 = engine_run(ref_path, dis_path, eng)
        what = f"{label} {name}"
        check_mesh_scores(what, got, want)
        check_mesh_launches(what, launches, single_launches, mesh.size)
        log(f"(9a) {what}: {FRAMES} frames in {s2:.2f} s over {mesh.size} shards, {s1:.2f} s unsharded (first "
            f"calls and decode included); launches {launches} [{card}]")
        out[name] = (s1, s2)
    return out


def load_raw_pair(ref_path: str, dis_path: str):
    """The Y4M pair's frames on the host: (ref frames, dis frames, ref cc,
    dis cc)."""
    from turbo_metrics_tpu_torch.io.probe import create_source

    srcs = (create_source(ref_path), create_source(dis_path))
    frames = [[src.get_frame() for _ in range(FRAMES)] for src in srcs]
    ccs = [src.color_characteristics() for src in srcs]
    for src in srcs:
        src.close()
    return frames[0], frames[1], ccs[0], ccs[1]


def check_mesh_trace(raw, dev, mesh, tmp: str, card: str) -> None:
    """Phase 9 (b): one steady-state mesh batch (all six metrics) inside
    device_trace, after one marker kernel on the default stream: besides the
    default stream (the marker's, then the gather's) the trace's kernels lie
    on exactly two streams, the two shards', with equal launches of every
    kernel but the later shard's one more motion_kernel (#17 on its previous
    shard's last reference frame)."""
    from collections import Counter

    from turbo_metrics_tpu_torch.utils.profiling import device_trace, kernel_name

    fr, fd, cc_r, cc_d = raw
    name, flags, integer, fused = MESH_CONFIGS[0]
    eng = mesh_engine(flags, integer, fused, dev, mesh)
    eng.compute_frames(fr[:BATCH], cc_r, fd[:BATCH], cc_d)
    with device_trace(os.path.join(tmp, "mesh_trace")) as log_dir:
        torch.ones(1, device=dev)
        torch.cuda.synchronize(dev)
        eng.compute_frames(fr[BATCH:2 * BATCH], cc_r, fd[BATCH:2 * BATCH], cc_d)
    files = sorted(os.listdir(log_dir))
    need(len(files) == 1, f"(9b) device_trace wrote {files}")
    with open(os.path.join(log_dir, files[0])) as f:
        kernels = sorted((e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"),
                         key=lambda e: e["ts"])
    need(len(kernels) > 1, f"(9b) the trace holds {len(kernels)} kernels")
    default = kernels[0]["args"]["stream"]
    per_stream: dict = {}
    for e in kernels[1:]:
        per_stream.setdefault(e["args"]["stream"], Counter())[kernel_name(e["name"]).split("<", 1)[0]] += 1
    on_default = per_stream.pop(default, Counter())
    log(f"(9b) trace {files[0]} of one mesh batch ({name}): kernels by stream "
        f"{ {k: sum(v.values()) for k, v in per_stream.items()} }, {sum(on_default.values())} more on the "
        f"default stream {default}; the shards' streams by kernel {[dict(v) for v in per_stream.values()]} "
        f"[{card}]")
    need(len(per_stream) == 2, f"(9b) the shards' kernels lie on {len(per_stream)} streams, want 2")
    a, b = per_stream.values()
    extra = (b - a) + (a - b)
    need(extra == Counter({"motion_kernel": 1}),
         f"(9b) the two shards' launches differ by {dict(extra)}, want one motion_kernel (the edge blur)")
    log(f"(9b) two streams, {sum(a.values())} and {sum(b.values())} launches: equal but the later shard's "
        "edge blur")


def time_mesh_batch(raw, dev, mesh, card: str) -> dict:
    """Phase 9 (e): one batch's compute_frames (all six metrics), unsharded
    and over the mesh, by CUDA events around the call (the uploads and the
    read-back of the scores included): unsharded, mesh, mesh, unsharded.
    Written down, not claimed."""
    from turbo_metrics_tpu_torch.tools.kernel_dissect import time_ms

    fr, fd, cc_r, cc_d = raw
    _, flags, integer, fused = MESH_CONFIGS[0]
    engines = {"unsharded": mesh_engine(flags, integer, fused, dev),
               f"{mesh.size} shards": mesh_engine(flags, integer, fused, dev, mesh)}
    times = {k: [] for k in engines}
    for k in (*engines, *reversed(engines)):
        times[k].append(time_ms(lambda: engines[k].compute_frames(fr[:BATCH], cc_r, fd[:BATCH], cc_d), 5, dev))
    for k, t in times.items():
        log(f"(9e) one batch B={BATCH} {WIDTH}x{HEIGHT}, all six metrics, {k}: "
            + " / ".join(f"{x:.3f} ms" for x in t) + f" (CUDA events around compute_frames) [{card}]")
    split_mesh_batch(engines, raw, card)
    return times


def split_mesh_batch(engines: dict, raw, card: str, calls: int = 3) -> None:
    """Where one batch's time goes, each way, by the host clock with the
    device synced after each part (so the shards run one after the other):
    the uploads inside ``_step`` (``_planes``), the launches with their
    device work (``_step``, every shard, its uploads taken out), the edge
    frames' uploads outside ``_step`` (a later shard's previous frame) and
    the host scoring (``_scores``), per batch over ``calls`` calls; and the
    device time of the batch's kernels by torch.profiler."""
    from turbo_metrics_tpu_torch.utils.profiling import Timer, cuda_kernel_records

    fr, fd, cc_r, cc_d = raw

    def batch(eng):
        return eng.compute_frames(fr[:BATCH], cc_r, fd[:BATCH], cc_d)

    def run(timer, fn, *args):
        out = []
        with timer.measure(out):
            out.append(fn(*args))
        return out[0]

    for k, eng in engines.items():
        timers = {name: Timer() for name in ("uploads", "step", "edge", "scoring")}
        inside = []

        def step(*args, _fn=eng._step):
            inside.append(True)
            try:
                return run(timers["step"], _fn, *args)
            finally:
                inside.pop()

        eng._step = step
        eng._planes = lambda *a, _fn=eng._planes: run(timers["uploads" if inside else "edge"], _fn, *a)
        eng._scores = lambda *a, _fn=eng._scores: run(timers["scoring"], _fn, *a)
        try:
            for _ in range(calls):
                batch(eng)
        finally:
            for name in ("_step", "_planes", "_scores"):
                delattr(eng, name)
        ms = {name: 1e3 * sum(t.samples) / calls for name, t in timers.items()}
        device_ms = sum(t for _, t in cuda_kernel_records(lambda: batch(eng)))
        log(f"(9e) split of one batch, {k}: uploads {ms['uploads']:.3f} ms, launches and device work "
            f"{ms['step'] - ms['uploads']:.3f} ms, edge uploads {ms['edge']:.3f} ms, host scoring "
            f"{ms['scoring']:.3f} ms (host clock, synced after each part, mean of {calls}); its kernels' "
            f"device time {device_ms:.3f} ms (torch.profiler) [{card}]")


def run_mesh_phase(dev, card: str) -> dict:
    """Phase 9: (a) the three configurations over two shards of card 0, (b)
    the trace, (c) every card where there are several, (d) the dry run,
    (e) the times."""
    from turbo_metrics_tpu_torch.parallel import dryrun
    from turbo_metrics_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MESH_SHARDS, device=f"cuda:{dev.index or 0}")
    with tempfile.TemporaryDirectory(prefix="tm_mesh_") as tmp:
        ref_path, dis_path = write_y4m_pair(tmp)
        runs = run_mesh_configs(ref_path, dis_path, dev, mesh, card, f"{MESH_SHARDS} shards of {dev}")
        raw = load_raw_pair(ref_path, dis_path)
        check_mesh_trace(raw, dev, mesh, tmp, card)
        if torch.cuda.device_count() > 1:
            every = make_mesh()
            runs.update({f"{k} ({every.size} cards)": v for k, v in run_mesh_configs(
                ref_path, dis_path, dev, every, card, f"{every.size} cards").items()})
        else:
            log("(9c) one card: the cross-device path (shards on distinct cards) went unexercised")
        reset_counts()
        dryrun.dryrun_multichip(MESH_SHARDS, device=str(mesh.devices[0]))
        launches = read_counts()
        need(all(launches[k] > 0 for k in ("yuv420_to_linear_rgb_pair", "fused_scale_rgb", "ssim_sums",
                                             "xpsnr_block_stats", "vif_scale0", "adm_stats", "motion_stats")),
             f"(9d) a kernel of the dry run was not launched: {launches}")
        log(f"(9d) dryrun_multichip({MESH_SHARDS}, device={str(mesh.devices[0])!r}): ok, launches {launches}")
        times = time_mesh_batch(raw, dev, mesh, card)
    return {"runs": runs, "batch_ms": times}


# Phase 10: width sharding.  One 8K frame pair (B=1), the columns split over
# strips of card 0, each on its own stream; tests/test_parallel.py's bar
# (sharded vs single, atol/rtol 2e-5), the score within 1e-5.
WIDE_WIDTH, WIDE_HEIGHT = 7680, 4320
# 2 and 4 strips; 8, whose 1280-column strips send levels 1-5 to kernel 2.
WIDTH_STRIPS = (2, 4, 8)
WIDTH_TOL, WIDTH_SCORE_TOL = 2e-5, 1e-5
# Phase 5d's bars for a level kernel's sums against its twin.
SUMS_RTOL, SUMS_ATOL = 1e-4, 1e-5
# Windows of owned columns that cut 32-column tiles mid-way (10b): (what,
# h, w, window, batch).
WINDOW_CASES = (("67x99", 67, 99, (13, 77), 2), ("4K level 3", 270, 480, (45, 301), 4),
                ("odd 8K strip", WIDE_HEIGHT, 2081, (160, 2081), 1))


def wide_pairs(dev, seed: int = 17):
    """Phase 10's seeded 7680x4320 B=1 pairs, made on the card: linear RGB
    (a smooth base with noise, the distorted copy noisier), (B, 3, h, w) f32
    each, and 8-bit 4:2:0 BT.709 limited range (noise on a smooth base, the
    distorted copy within +-6): (2, B, h, w) luma, (2, B, h/2, w/2, 2)
    chroma."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w = WIDE_HEIGHT, WIDE_WIDTH
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    base = torch.stack([0.5 + 0.4 * torch.sin(xx / 17.0) * torch.cos(yy / 23.0),
                        0.5 + 0.3 * torch.cos(xx / 11.0 + 1.0) * torch.sin(yy / 31.0),
                        0.5 + 0.2 * torch.sin((xx + yy) / 13.0)])[None]

    def noise(shape, sigma):
        return sigma * torch.randn(shape, device=dev, generator=g)

    ref = (base + noise(base.shape, 0.01)).clamp(0, 1)
    dis = (ref + noise(ref.shape, 0.02)).clamp(0, 1)
    luma = 128 + 70 * torch.sin(xx / 9.0) * torch.cos(yy / 7.0)
    cy = torch.arange(h // 2, device=dev, dtype=torch.float32)[:, None]
    cx = torch.arange(w // 2, device=dev, dtype=torch.float32)[None, :]
    chroma = torch.stack([128 + 40 * torch.sin(cx / 5.0) + 0 * cy, 128 + 40 * torch.cos(cy / 4.0) + 0 * cx], -1)
    y_r = (luma + noise(luma.shape, 3.0))[None]
    uv_r = (chroma + noise(chroma.shape, 3.0))[None]
    y2 = torch.stack([y_r, y_r + torch.randint(-6, 7, y_r.shape, device=dev, generator=g)])
    uv2 = torch.stack([uv_r, uv_r + torch.randint(-6, 7, uv_r.shape, device=dev, generator=g)])

    def codes(t):
        return t.round().clamp(16, 235).to(torch.uint8).contiguous()

    return (ref.contiguous(), dis.contiguous()), (codes(y2), codes(uv2))


def width_entries(model, rgb, yuv):
    """(entry, function, inputs, in_ndims, unsharded call) of phase 10's two
    entries: linear RGB through ssimulacra2_subscores (pallas3; unsharded
    through the module's forward) and 8-bit 4:2:0 through
    ssimulacra2_subscores_from_yuv (kernel 1, then the level chain)."""
    import functools

    from turbo_metrics_tpu_torch.models.ssimulacra2 import (
        ssimulacra2_subscores,
        ssimulacra2_subscores_from_yuv,
    )

    consts = dict(num_scales=model.num_scales, taps=model.taps, opsin=model.opsin)
    f_rgb = functools.partial(ssimulacra2_subscores, backend="pallas3", **consts)
    f_yuv = functools.partial(ssimulacra2_subscores_from_yuv, **consts)
    return (("RGB", f_rgb, rgb, (4, 4), lambda: model(*rgb)),
            ("YUV 4:2:0", f_yuv, yuv, (4, 5), lambda: model.subscores_from_yuv(*yuv)))


def strip_launches(plan, h: int, num_scales: int, yuv: bool) -> dict:
    """The wrappers the strips of ``plan`` launch, once per kernel of each
    strip's own route: kernel 1 then the chain from level 1 (YUV), or the
    chain from level 0 (RGB)."""
    from turbo_metrics_tpu_torch.models.ssimulacra2 import level_route

    want: dict = {}
    for s in plan:
        first = 1 if yuv else 0
        if yuv:
            want["fused_scale0_yuv"] = want.get("fused_scale0_yuv", 0) + 1
        for k, _ in level_route(-(-h >> first), -(-s.width >> first), num_scales, first):
            want[k] = want.get(k, 0) + 1
    return want


def run_width_configs(model, rgb, yuv, mesh_of, card: str, label: str, strips=WIDTH_STRIPS,
                      host: bool = False, tag: str = "(10a)") -> dict:
    """Phase 10 (a) (and (c) over every card): each entry unsharded on the
    card's inputs, then over each mesh of ``mesh_of(n)`` for n in
    ``strips`` (``host``: the sharded calls take host copies of the inputs,
    which each strip cuts and uploads to its own card), counters reset just
    before and read just after each run: sub-scores within WIDTH_TOL,
    scores within WIDTH_SCORE_TOL, every wrapper of the strips' routes
    launched once per strip.  Returns {(entry, n): (max abs diff, score
    diff)}."""
    from turbo_metrics_tpu_torch.parallel.mesh import halo_overhead, shard_over_width, spatial_sharding

    out = {}
    for entry, fn, args, ndims, single in width_entries(model, rgb, yuv):
        shard_args = tuple(t.cpu() for t in args) if host else args
        reset_counts()
        want = single()
        single_launches = {k: v for k, v in read_counts().items() if v}
        want_score = float(model.score(want)[0])
        log(f"{tag} {entry} {WIDE_WIDTH}x{WIDE_HEIGHT} B=1 unsharded: score {want_score:.6f}, launches "
            f"{single_launches} [{card}]")
        for n in strips:
            mesh = mesh_of(n)
            plan = spatial_sharding(mesh, WIDE_WIDTH, num_scales=model.num_scales, chroma=entry != "RGB")
            reset_counts()
            got = shard_over_width(fn, mesh, in_ndims=ndims)(*shard_args)
            launches = {k: v for k, v in read_counts().items() if v}
            what = f"{tag} {label}: {entry} over {n} strips"
            need(tuple(got.shape) == tuple(want.shape) and got.device == mesh.devices[0],
                 f"{what}: sub-scores {tuple(got.shape)} on {got.device}")
            need(bool(torch.isfinite(got).all()), f"{what}: non-finite sub-scores")
            err = check_close(what, got.to(want.device), want, WIDTH_TOL, WIDTH_TOL)
            rel = float(((got.to(want.device) - want).abs() / want.abs().clamp_min(1e-30)).max())
            score = float(model.score(got)[0])
            need(abs(score - want_score) <= WIDTH_SCORE_TOL,
                 f"{what}: score {score} vs unsharded {want_score}")
            expect = strip_launches(plan, WIDE_HEIGHT, model.num_scales, entry != "RGB")
            need(launches == expect, f"{what}: launches {launches}, want {expect} (one per kernel of each "
                 "strip's route)")
            log(f"{what} ({', '.join(f'[{s.lo}, {s.hi}) owns {s.own_hi - s.own_lo}' for s in plan)}; halo "
                f"overhead {halo_overhead(plan):.4f}): sub-scores max |diff| {err:.3g}, max rel {rel:.3g}; "
                f"score {score:.6f}, |diff| {abs(score - want_score):.3g}; launches {launches} [{card}]")
            out[(entry, n)] = (err, abs(score - want_score))
    return out


def check_window_kernels(dev, taps, opsin, card: str) -> dict:
    """Phase 10 (b): kernels 1, 2, #3 and #4 with windows of owned columns
    that cut tiles mid-way (WINDOW_CASES) against their twins on the same
    inputs, sums at phase 5d's bars.  Returns each wrapper's largest
    difference."""
    from turbo_metrics_tpu_torch.ops.kernels import fused_tail, scale_stats, scale_tail

    g = torch.Generator(device=dev).manual_seed(23)
    errs = {}
    for what, h, w, win, b in WINDOW_CASES:
        p12 = torch.rand((2, b, 3, h, w), device=dev, generator=g)
        y2 = torch.randint(16, 236, (2, b, h, w), device=dev, generator=g, dtype=torch.uint8)
        uv2 = torch.randint(16, 241, (2, b, (h + 1) // 2, (w + 1) // 2, 2), device=dev, generator=g,
                            dtype=torch.uint8)
        lv, nxt = 5, scale_stats.next_window(*win)
        lvl1 = scale_stats.fused_scale_rgb(p12, taps, opsin)[1]
        calls = {
            "fused_scale0_yuv": (lambda: scale_stats.fused_scale0_yuv(y2, uv2, taps, opsin, columns=win),
                                 lambda: scale_stats.fused_scale0_yuv_ref(y2, uv2, taps, opsin, columns=win)),
            "fused_scale_rgb": (lambda: scale_stats.fused_scale_rgb(p12, taps, opsin, columns=win),
                                lambda: scale_stats.fused_scale_rgb_ref(p12, taps, opsin, columns=win)),
            "fused_pyramid_tail": (lambda: scale_tail.fused_pyramid_tail(lvl1, lv, taps, opsin, columns=nxt),
                                   lambda: scale_tail.fused_pyramid_tail_ref(lvl1, lv, taps, opsin, columns=nxt)),
            "fused_tail": (lambda: fused_tail.fused_tail(lvl1, lv, taps, opsin, columns=nxt),
                           lambda: fused_tail.fused_tail_ref(lvl1, lv, taps, opsin, columns=nxt)),
        }
        line = []
        for name, (kern, twin) in calls.items():
            got, want = kern(), twin()
            if isinstance(got, tuple):
                (got, got_l1), (want, want_l1) = got, want
                check_close(f"(10b) {name} {what} level 1", got_l1, want_l1, 0.0, 1e-5)
            e = check_close(f"(10b) {name} {what} window {win if name.startswith('fused_scale') else nxt}",
                            got, want, SUMS_RTOL, SUMS_ATOL)
            rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
            errs[name] = max(errs.get(name, 0.0), e)
            line.append(f"{name} max abs {e:.3g} rel {rel:.3g}")
        log(f"(10b) windowed kernels vs twins, {what} (B={b}, level-0 window {win}, from level 1 {nxt}): "
            + "; ".join(line) + f" [{card}]")
    return errs


def width_trace(fn, args, ndims, mesh, tmp: str, card: str) -> None:
    """Phase 10 (d): one sharded call inside device_trace: the streams its
    kernels ran on and whether #4's grids (fused_tail_kernel, each sized to
    the whole card) overlapped in time."""
    from turbo_metrics_tpu_torch.parallel.mesh import shard_over_width
    from turbo_metrics_tpu_torch.utils.profiling import device_trace, kernel_name

    sharded = shard_over_width(fn, mesh, in_ndims=ndims)
    sharded(*args)
    with device_trace(os.path.join(tmp, "width_trace")) as log_dir:
        sharded(*args)
        torch.cuda.synchronize()
    files = sorted(os.listdir(log_dir))
    need(len(files) == 1, f"(10d) device_trace wrote {files}")
    with open(os.path.join(log_dir, files[0])) as f:
        kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    tails = sorted((e for e in kernels if kernel_name(e["name"]).startswith("fused_tail_kernel")),
                   key=lambda e: e["ts"])
    streams = sorted({e["args"]["stream"] for e in kernels})
    overlaps = sum(1 for a, b in zip(tails, tails[1:]) if b["ts"] < a["ts"] + a["dur"])
    log(f"(10d) trace {files[0]} of one call over {mesh.size} strips: {len(kernels)} kernels on streams "
        f"{streams}; #4 grids {len(tails)} on streams {[e['args']['stream'] for e in tails]}, "
        f"{[round(e['dur'], 1) for e in tails]} us, {overlaps} of {max(len(tails) - 1, 0)} consecutive pairs "
        f"overlapping ({'serialised' if tails and not overlaps else 'concurrent'}) [{card}]")
    need(len(tails) == mesh.size, f"(10d) {len(tails)} #4 grids in the trace, want {mesh.size}")


def time_width(model, rgb, yuv, mesh_of, card: str) -> dict:
    """Phase 10 (d): one call of each entry unsharded and over each strip
    count of WIDTH_STRIPS on card 0, by CUDA events (unsharded, 2, 4, 8, 8,
    4, 2, unsharded), and each call's peak device memory above its
    inputs."""
    from turbo_metrics_tpu_torch.parallel.mesh import shard_over_width
    from turbo_metrics_tpu_torch.utils.profiling import time_ms

    out = {}
    dev = model.device
    for entry, fn, args, ndims, single in width_entries(model, rgb, yuv):
        calls = {"unsharded": lambda f=fn, a=args: f(*a)}
        for n in WIDTH_STRIPS:
            calls[f"{n} strips"] = (lambda s=shard_over_width(fn, mesh_of(n), in_ndims=ndims), a=args: s(*a))
        times = {k: [] for k in calls}
        for k in (*calls, *reversed(calls)):
            times[k].append(time_ms(calls[k], 5, dev))
        peaks = {k: step_peak_mib(c, dev) for k, c in calls.items()}
        reserved = {k: peak_reserved_mib(c, dev) for k, c in calls.items()}
        for k in calls:
            log(f"(10d) {entry} {WIDE_WIDTH}x{WIDE_HEIGHT} B=1, {k}: " + " / ".join(f"{t:.3f}" for t in times[k])
                + f" ms (CUDA events, one call), peak device memory above its inputs {peaks[k]:.1f} MiB "
                f"allocated, {reserved[k]:.1f} MiB reserved by the caching allocator [{card}]")
        out[entry] = {"ms": times, "peak_mib": peaks, "reserved_mib": reserved}
    return out


def peak_reserved_mib(fn, dev) -> float:
    """The device memory the caching allocator reserves for one fn() call
    from an emptied cache, in MiB.  Strips on side streams free their
    temporaries at enqueue, which the allocated peak does not see while
    their blocks stay held for their streams."""
    torch.cuda.synchronize(dev)
    RUN_PEAK[0] = max(RUN_PEAK[0], torch.cuda.max_memory_allocated(dev))
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return (torch.cuda.max_memory_reserved(dev) - base) / 2**20


def run_width_cards(model, rgb, yuv, card: str) -> dict:
    """Phase 10 (c): (a) from host copies of the inputs, which each strip
    cuts and uploads to its card, against the unsharded run on card 0's
    tensors: with one strip per card (cards 0 .. n-1 for each strip count
    up to the cards there are) where there are several, else over two
    strips of the one card."""
    from turbo_metrics_tpu_torch.parallel.mesh import make_mesh

    every = torch.cuda.device_count()
    if every < 2:
        runs = run_width_configs(model, rgb, yuv, lambda n: make_mesh(n, device="cuda:0"), card,
                                 "strips of cuda:0 (host inputs)", strips=(2,), host=True, tag="(10c)")
        log("(10c) one card: host inputs over its strips checked; the cross-device path (one strip per "
            "card) went unexercised")
        return {("host", *k): v for k, v in runs.items()}
    strips = sorted({min(n, every) for n in WIDTH_STRIPS})
    runs = run_width_configs(model, rgb, yuv, lambda n: make_mesh(n), card,
                             "one strip per card (host inputs)", strips=strips, host=True, tag="(10c)")
    return {("cards", *k): v for k, v in runs.items()}


def run_width_phase(dev, model, card: str) -> dict:
    """Phase 10: (a) both entries over 2, 4 and 8 strips of card 0, (b) the
    windowed kernels against their twins, (c) every card where there are
    several, (d) the times, the peak memory and the trace of #4's grids."""
    from turbo_metrics_tpu_torch.parallel.mesh import make_mesh

    rgb, yuv = wide_pairs(dev)
    card0 = f"cuda:{dev.index or 0}"
    runs = run_width_configs(model, rgb, yuv, lambda n: make_mesh(n, device=card0), card,
                             f"strips of {card0}")
    errs = check_window_kernels(dev, model.taps, model.opsin, card)
    runs.update(run_width_cards(model, rgb, yuv, card))
    times = time_width(model, rgb, yuv, lambda n: make_mesh(n, device=card0), card)
    entry, fn, args, ndims, _ = width_entries(model, rgb, yuv)[0]
    with tempfile.TemporaryDirectory(prefix="tm_width_") as tmp:
        width_trace(fn, args, ndims, make_mesh(4, device=card0), tmp, card)
    return {"runs": runs, "window_err": errs, "times": times}


# Phase 11: width sharding of PSNR, SSIM, MS-SSIM and XPSNR.  The 8K frame
# of phase 10 (B=1) over the same strips of card 0, each on its own stream;
# tests/test_parallel.py's score bar for SSIM and MS-SSIM, PSNR and XPSNR
# bit for bit.
METRIC_TOL = 1e-6
# Phase 5a's bars for #11 / #12 against their twins.
SSIM_SUMS_RTOL = 1e-5
# Windows of owned columns whose valid outputs start and end inside 32-column
# tiles (11c): (what, h, w, level-0 window, batch).
SSIM_WINDOW_CASES = (("67x99", 67, 99, (13, 77), 2), ("1080p level", HEIGHT, WIDTH, (45, 1301), 2),
                     ("odd 8K strip", WIDE_HEIGHT, 2081, (160, 2081), 1))


def wide_metric_inputs(dev, seed: int = 19):
    """Phase 11's seeded 7680x4320 B=1 inputs, made on the card: the
    linear-RGB pair buffer (2, 1, 3, h, w) of phase 10's pair, and per
    XPSNR case (what, y_ref, y_dis, prev0, dis_shift): u8 luma (noise on a
    smooth base, the distorted copy within +-6, the previous reference
    shifted), and a 10-bit u16 reference against the 8-bit distorted
    luma."""
    (ref, dis), _ = wide_pairs(dev)
    p12 = torch.stack([ref, dis]).contiguous()
    del ref, dis
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w = WIDE_HEIGHT, WIDE_WIDTH
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    base = 128 + 70 * torch.sin(xx / 9.0) * torch.cos(yy / 7.0)
    y8 = (base + 3 * torch.randn((1, h, w), device=dev, generator=g)).round().clamp(0, 255)
    d8 = (y8 + torch.randint(-6, 7, y8.shape, device=dev, generator=g)).clamp(0, 255)
    prev8 = torch.roll(y8[0], 3, dims=1)
    y10 = y8 * 4 + torch.randint(0, 4, y8.shape, device=dev, generator=g)
    prev10 = torch.roll(y10[0], 3, dims=1)

    def u8(t):
        return t.to(torch.uint8).contiguous()

    def u16(t):
        return t.to(torch.int32).to(torch.uint16).contiguous()

    return p12, (("u8", u8(y8), u8(d8), u8(prev8), 0),
                 ("10-bit u16 vs 8-bit", u16(y10), u8(d8), u16(prev10), 2))


def metric_entries(qmod, p12, xp_cases):
    """(entry, function, inputs, in_ndims, what it launches per strip) of
    phase 11's entries: quality_from_rgb with PSNR, SSIM and MS-SSIM, and
    the kernel route's xpsnr_block_stats per XPSNR case."""
    import functools

    from turbo_metrics_tpu_torch.ops.kernels.xpsnr import xpsnr_block_stats
    from turbo_metrics_tpu_torch.ops.quality import quality_from_rgb

    f_q = functools.partial(quality_from_rgb, window=qmod.window, want_psnr=True, want_ssim=True,
                            want_msssim=True, levels=MS_LEVELS, c1=qmod.c1, c2=qmod.c2,
                            weights=qmod.msssim_weights)
    out = [("PSNR/SSIM/MS-SSIM", f_q, (p12,), (5,), {"ssim_sums": 1, "msssim_tail": 1})]
    for what, y_ref, y_dis, prev0, shift in xp_cases:
        out.append((f"XPSNR {what}", functools.partial(xpsnr_block_stats, dis_shift=shift),
                    (y_ref, y_dis, prev0), (3, 3, 2), {"xpsnr_block_stats": 1}))
    return out


def metric_plan(fn, mesh, w: int):
    """The strips shard_over_width cuts for ``fn`` (phase 11's entries)."""
    from turbo_metrics_tpu_torch.ops import quality
    from turbo_metrics_tpu_torch.parallel.mesh import spatial_sharding

    if fn.func is quality.quality_from_rgb:
        lv, _ = quality._clamp_levels(WIDE_HEIGHT, w, MS_LEVELS)
        return spatial_sharding(mesh, w, num_scales=lv)
    return spatial_sharding(mesh, w, alignment=16, halo=16)


def xpsnr_db_of(grids: dict, depth: int) -> list:
    from turbo_metrics_tpu_torch.ops.xpsnr_ops import frames_db

    return [float(v) for v in frames_db({k: v.cpu() for k, v in grids.items()}, width=WIDE_WIDTH,
                                        height=WIDE_HEIGHT, depth=depth)]


def check_metric_outputs(what: str, entry: str, got: dict, want: dict, depth: int) -> dict:
    """Phase 11 (a)/(b): PSNR, the XPSNR grids and dB bit-equal, SSIM and
    MS-SSIM within METRIC_TOL; returns each output's largest difference."""
    need(list(got) == list(want), f"{what}: outputs {list(got)}, want {list(want)}")
    diffs = {}
    for k, v in want.items():
        g = got[k].to(v.device)
        need(g.shape == v.shape and g.dtype == v.dtype, f"{what}: {k} {tuple(g.shape)} {g.dtype}")
        diffs[k] = float((g.double() - v.double()).abs().max())
        if k in ("ssim", "msssim"):
            need(bool(torch.isfinite(g).all()) and diffs[k] <= METRIC_TOL,
                 f"{what}: {k} {g.tolist()} vs unsharded {v.tolist()} (bar {METRIC_TOL})")
        else:
            need(torch.equal(g, v), f"{what}: {k} differs from the unsharded call's, max |diff| {diffs[k]:.3g}")
    if entry.startswith("XPSNR"):
        db, want_db = xpsnr_db_of(got, depth), xpsnr_db_of(want, depth)
        need(db == want_db, f"{what}: XPSNR {db} dB vs unsharded {want_db}")
    return diffs


def output_tensors(out) -> list:
    """The tensors of an entry's result: a tensor, a tuple's, or a dict's
    values."""
    if isinstance(out, dict):
        return list(out.values())
    return list(out) if isinstance(out, tuple) else [out]


def run_strip_entries(entries, plan_of, check, describe, mesh_of, card: str, label: str, strips, host: bool,
                      tag: str) -> dict:
    """Phases 11 and 12, the strip runs: each entry (entry, function,
    inputs, in_ndims, launches per strip) unsharded on the card's inputs,
    then over each mesh of ``mesh_of(n)`` for n in ``strips`` (``host``:
    the sharded calls take host copies of the inputs), counters reset just
    before and read just after each run, every wrapper of the entry
    launched once per strip.  ``plan_of(fn, mesh)``: the strips
    shard_over_width cuts; ``check(what, entry, got, want)``: (each output's
    largest difference, what was equal), failing the run past the phase's
    bars; ``describe(entry, want)``: what the unsharded call gave.  Returns
    {(entry, n): the differences}."""
    from turbo_metrics_tpu_torch.parallel.mesh import halo_overhead, shard_over_width

    out = {}
    for entry, fn, args, ndims, per_strip in entries:
        shard_args = tuple(t.cpu() for t in args) if host else args
        reset_counts()
        want = fn(*args)
        single = {k: v for k, v in read_counts().items() if v}
        need(single == per_strip, f"{tag} {entry} unsharded: launches {single}, want {per_strip}")
        log(f"{tag} {entry} unsharded: {describe(entry, want)}, launches {single} [{card}]")
        for n in strips:
            mesh = mesh_of(n)
            plan = plan_of(fn, mesh)
            reset_counts()
            got = shard_over_width(fn, mesh, in_ndims=ndims)(*shard_args)
            launches = {k: v for k, v in read_counts().items() if v}
            what = f"{tag} {label}: {entry} over {n} strips"
            need(all(v.device == mesh.devices[0] for v in output_tensors(got)), f"{what}: not on {mesh.devices[0]}")
            diffs, equal = check(what, entry, got, want)
            expect = {k: v * n for k, v in per_strip.items()}
            need(launches == expect, f"{what}: launches {launches}, want {expect} (once per strip)")
            shown = ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
            log(f"{what} ({', '.join(f'[{s.lo}, {s.hi}) owns {s.own_hi - s.own_lo}' for s in plan)}; halo "
                f"overhead {halo_overhead(plan):.5f}): " + (f"max |diff| {shown}; " if shown else "")
                + f"{equal}; launches {launches} [{card}]")
            out[(entry, n)] = diffs
    return out


def run_metric_configs(qmod, p12, xp_cases, mesh_of, card: str, label: str, strips=WIDTH_STRIPS,
                       host: bool = False, tag: str = "(11a/b)") -> dict:
    """Phase 11 (a), (b) (and (d)): run_strip_entries of phase 11's
    entries.  Returns {(entry, n): each output's largest difference}."""
    depths = {f"XPSNR {c[0]}": 10 if c[4] else 8 for c in xp_cases}

    def describe(entry, want):
        shown = {k: [round(x, 7) for x in v.tolist()] for k, v in want.items() if v.ndim == 1}
        return (f"{WIDE_WIDTH}x{WIDE_HEIGHT} B=1 {shown or 'grids'}"
                + (f", XPSNR {xpsnr_db_of(want, depths[entry])[0]!r} dB" if entry in depths else ""))

    def check(what, entry, got, want):
        diffs = check_metric_outputs(what, entry, got, want, depths.get(entry, 8))
        return diffs, "grids and dB bit-equal" if entry in depths else "PSNR bit-equal"

    return run_strip_entries(metric_entries(qmod, p12, xp_cases), lambda fn, m: metric_plan(fn, m, WIDE_WIDTH),
                             check, describe, mesh_of, card, label, strips, host, tag)


def check_ssim_windows(dev, win, card: str) -> dict:
    """Phase 11 (c): #11 (quantizing a linear-RGB pair, and on code values)
    and #12 (four levels from the emitted level, three at 67x99) with windows
    of owned columns that cut tiles mid-way (SSIM_WINDOW_CASES) against
    their twins on the same inputs, sums at phase 5a's bars, the emitted
    level equal; and each with the full window bit-equal to no window.
    Returns each wrapper's largest difference."""
    from turbo_metrics_tpu_torch.ops.kernels import windowed, windowed_tail

    g = torch.Generator(device=dev).manual_seed(29)
    errs = {"ssim_sums": 0.0, "msssim_tail": 0.0}
    for what, h, w, win_cols, b in SSIM_WINDOW_CASES:
        lin = torch.rand((2, b, 3, h, w), device=dev, generator=g)
        noise = torch.randint(-20, 21, (b, 3, h, w), device=dev, generator=g)
        ref = torch.randint(0, 256, (b, 3, h, w), device=dev, generator=g)
        codes = torch.stack([ref, (ref + noise).clamp(0, 255)]).float().contiguous()
        line = []
        for name, p, quantize in (("quantize", lin, True), ("codes", codes, False)):
            kw = dict(quantize=quantize, emit_ds=True)
            s_k, d_k = windowed.ssim_sums(p, win, **kw, columns=win_cols)
            s_p, d_p = windowed.ssim_sums_ref(p, win, **kw, columns=win_cols)
            e = check_close(f"(11c) #11 {name} {what} window {win_cols}", s_k, s_p, SSIM_SUMS_RTOL, 0.0)
            need(torch.equal(d_k, d_p), f"(11c) #11 {name} {what}: the emitted level differs from the twin's")
            full = windowed.ssim_sums(p, win, **kw, columns=(0, w))
            plain = windowed.ssim_sums(p, win, **kw)
            need(torch.equal(full[0], plain[0]) and torch.equal(full[1], plain[1]),
                 f"(11c) #11 {name} {what}: the full window differs from no window")
            errs["ssim_sums"] = max(errs["ssim_sums"], e)
            rel = float(((s_k - s_p).abs() / s_p.abs()).max())
            line.append(f"#11 {name} max abs {e:.3g} rel {rel:.3g}")
        l1 = d_p
        lv = 1  # #12's levels from level 1: as many as fit, at most MS-SSIM's four
        while min(l1.shape[-2:]) >> lv >= 11 and lv < MS_LEVELS - 1:
            lv += 1
        cols1 = (win_cols[0] // 2, win_cols[1] // 2)
        t_k = windowed_tail.msssim_tail(l1, lv, win, columns=cols1)
        t_p = windowed_tail.msssim_tail_ref(l1, lv, win, columns=cols1)
        e = check_close(f"(11c) #12 {what} {lv} levels window {cols1}", t_k, t_p, SSIM_SUMS_RTOL, 0.0)
        need(torch.equal(windowed_tail.msssim_tail(l1, lv, win, columns=(0, l1.shape[-1])),
                         windowed_tail.msssim_tail(l1, lv, win)),
             f"(11c) #12 {what}: the full window differs from no window")
        errs["msssim_tail"] = max(errs["msssim_tail"], e)
        rel = float(((t_k - t_p).abs() / t_p.abs()).max())
        line.append(f"#12 {lv} levels from {l1.shape[-1]}x{l1.shape[-2]} window {cols1} max abs {e:.3g} rel {rel:.3g}")
        log(f"(11c) windowed kernels vs twins, {what} (B={b}, window {win_cols}): " + "; ".join(line)
            + f"; full windows bit-equal to none [{card}]")
        del lin, codes, ref, noise
    return errs


def time_metrics(qmod, p12, xp_cases, mesh_of, card: str) -> dict:
    """Phase 11 (e): time_strip_entries of phase 11's entries."""
    return time_strip_entries(metric_entries(qmod, p12, xp_cases), mesh_of, card, "(11e)",
                              f"{WIDE_WIDTH}x{WIDE_HEIGHT} B=1")


def time_strip_entries(entries, mesh_of, card: str, tag: str, shape: str) -> dict:
    """Phases 11 (e) and 12 (d): one call of each entry unsharded and over
    each strip count of WIDTH_STRIPS on card 0, by CUDA events (unsharded,
    2, 4, 8, 8, 4, 2, unsharded), and each call's peak device memory above
    its inputs (allocated, and reserved from an emptied cache)."""
    from turbo_metrics_tpu_torch.parallel.mesh import shard_over_width
    from turbo_metrics_tpu_torch.utils.profiling import time_ms

    out = {}
    for entry, fn, args, ndims, _ in entries:
        dev = args[0].device
        calls = {"unsharded": lambda f=fn, a=args: f(*a)}
        for n in WIDTH_STRIPS:
            calls[f"{n} strips"] = (lambda s=shard_over_width(fn, mesh_of(n), in_ndims=ndims), a=args: s(*a))
        times = {k: [] for k in calls}
        for k in (*calls, *reversed(calls)):
            times[k].append(time_ms(calls[k], 5, dev))
        peaks = {k: step_peak_mib(c, dev) for k, c in calls.items()}
        reserved = {k: peak_reserved_mib(c, dev) for k, c in calls.items()}
        for k in calls:
            log(f"{tag} {entry} {shape}, {k}: " + " / ".join(f"{t:.4f}" for t in times[k])
                + f" ms (CUDA events, one call), peak device memory above its inputs {peaks[k]:.1f} MiB "
                f"allocated, {reserved[k]:.1f} MiB reserved by the caching allocator [{card}]")
        out[entry] = {"ms": times, "peak_mib": peaks, "reserved_mib": reserved}
    return out


def run_metric_cards(qmod, p12, xp_cases, card: str) -> dict:
    """Phase 11 (d): (a) and (b) from host copies of the inputs, which each
    strip cuts and uploads to its card, against the unsharded run on card
    0's tensors: one strip per card where there are several, else two
    strips of the one card."""
    return run_strip_cards(lambda mesh_of, label, strips: run_metric_configs(
        qmod, p12, xp_cases, mesh_of, card, label, strips=strips, host=True, tag="(11d)"), "(11d)")


def run_strip_cards(run, tag: str) -> dict:
    """Phases 11 (d) and 12 (c): ``run(mesh_of, label, strips)`` (the strip
    runs from host copies of the inputs, which each strip cuts and uploads
    to its card) with one strip per card where there are several, else two
    strips of the one card."""
    from turbo_metrics_tpu_torch.parallel.mesh import make_mesh

    every = torch.cuda.device_count()
    if every < 2:
        runs = run(lambda n: make_mesh(n, device="cuda:0"), "strips of cuda:0 (host inputs)", (2,))
        log(f"{tag} one card: host inputs over its strips checked; the cross-device path (one strip per "
            "card) went unexercised")
        return {("host", *k): v for k, v in runs.items()}
    strips = sorted({min(n, every) for n in WIDTH_STRIPS})
    runs = run(lambda n: make_mesh(n), "one strip per card (host inputs)", strips)
    return {("cards", *k): v for k, v in runs.items()}


def run_metric_width_phase(dev, qmod, card: str) -> dict:
    """Phase 11: (a)/(b) every entry over 2, 4 and 8 strips of card 0, (c)
    the windowed #11 and #12 against their twins, (d) host inputs (every
    card where there are several), (e) the times and the peak memory."""
    from turbo_metrics_tpu_torch.parallel.mesh import make_mesh

    card0 = f"cuda:{dev.index or 0}"
    errs = check_ssim_windows(dev, qmod.window, card)
    p12, xp_cases = wide_metric_inputs(dev)
    runs = run_metric_configs(qmod, p12, xp_cases, lambda n: make_mesh(n, device=card0), card,
                              f"strips of {card0}")
    runs.update(run_metric_cards(qmod, p12, xp_cases, card))
    times = time_metrics(qmod, p12, xp_cases, lambda n: make_mesh(n, device=card0), card)
    return {"runs": runs, "window_err": errs, "times": times}


# Phase 12: width sharding of VMAF's float features.  A seeded 8K B=2 luma
# pair over the strips of card 0; the sums at rtol 1e-6, the features within
# 1e-6, motion and its blur bit for bit.
VMAF_SUMS_RTOL, VMAF_FEATURE_TOL = 1e-6, 1e-6
VMAF_WIDE_BATCH = 2
# Windows of owned columns that cut 32-column tiles (ADM's 32x32 band tiles)
# mid-way (12b): (what, h, w, frame width, first column in the frame,
# owned window, batch).  67x99 and 75x101 (ADM's odd band sizes) and the
# odd 8K edge strip take ADM's block loads (rows not whole 16-byte chunks),
# the 1080p frame and the interior 8K strip its tensor copies.
VMAF_WINDOW_CASES = (("67x99", 67, 99, 99, 0, (24, 77), 2), ("75x101", 75, 101, 101, 0, (40, 101), 2),
                     ("1080p", HEIGHT, WIDTH, WIDTH, 0, (40, 1301), 2),
                     ("interior 8K strip", WIDE_HEIGHT, 1024, WIDE_WIDTH + 1, 2848, (32, 992), 1),
                     ("odd-width 8K edge strip", WIDE_HEIGHT, 993, WIDE_WIDTH + 1, 6688, (32, 993), 1))


def wide_vmaf_inputs(dev, seed: int = 31):
    """Phase 12's seeded 7680x4320 B=2 inputs, made on the card: the u8 luma
    pair (noise on a smooth base, the distorted copy within +-6) as the
    (2, B, h, w) f32 pair of VIF and ADM, and per motion case (what, luma,
    prev0, depth): the u8 reference luma with prev0 the blur (#17) of a
    third seeded frame, and a 10-bit u16 luma (the u8 codes times 4 plus
    noise) with its own prev0."""
    from turbo_metrics_tpu_torch.engine import vmaf_pair
    from turbo_metrics_tpu_torch.ops.kernels import motion

    g = torch.Generator(device=dev).manual_seed(seed)
    h, w, b = WIDE_HEIGHT, WIDE_WIDTH, VMAF_WIDE_BATCH
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    base = 128 + 70 * torch.sin(xx / 9.0) * torch.cos(yy / 7.0)
    y8 = (base + 3 * torch.randn((b + 1, h, w), device=dev, generator=g)).round().clamp(0, 255)
    d8 = (y8[:b] + torch.randint(-6, 7, (b, h, w), device=dev, generator=g)).clamp(0, 255)
    y10 = y8 * 4 + torch.randint(0, 4, y8.shape, device=dev, generator=g)
    u8 = y8.to(torch.uint8).contiguous()
    u10 = y10.to(torch.int32).to(torch.uint16).contiguous()
    prev8 = motion.integer_blur(u8[b:])[0].contiguous()
    prev10 = motion.integer_blur(u10[b:], depth=10)[0].contiguous()
    pair = vmaf_pair(u8[:b].contiguous(), d8.to(torch.uint8).contiguous(), 8, 8)
    return pair, (("u8", u8[:b].contiguous(), prev8, 8), ("10-bit u16", u10[:b].contiguous(), prev10, 10))


def vmaf_entries(pair, motion_cases):
    """(entry, function, inputs, in_ndims, what it launches per strip) of
    phase 12's entries: vif_scale_stats and adm_stats on the pair, and per
    motion case motion_stats and integer_blur."""
    import functools

    from turbo_metrics_tpu_torch.ops.kernels import adm, motion, vif

    out = [("VIF", vif.vif_scale_stats, (pair,), (4,), {"vif_scale0": 1, "vif_tail": 1}),
           ("ADM", adm.adm_stats, (pair,), (4,), {"adm_stats": 1})]
    for what, y, prev0, depth in motion_cases:
        out.append((f"motion {what}", functools.partial(motion.motion_stats, depth=depth), (y, prev0), (3, 2),
                    {"motion_stats": 1}))
        out.append((f"#17 {what}", functools.partial(motion.integer_blur, depth=depth), (y,), (3,),
                    {"integer_blur": 1}))
    return out


def vmaf_plan(fn, mesh):
    """The strips shard_over_width cuts for ``fn`` (phase 12's entries)."""
    from turbo_metrics_tpu_torch.ops.kernels import adm, motion, vif
    from turbo_metrics_tpu_torch.parallel.mesh import spatial_sharding

    base = getattr(fn, "func", fn)
    mod = vif if base is vif.vif_scale_stats else adm if base is adm.adm_stats else motion
    return spatial_sharding(mesh, WIDE_WIDTH, alignment=mod.STRIP_ALIGNMENT, halo=mod.STRIP_HALO)


def vmaf_features(entry: str, sums) -> dict:
    from turbo_metrics_tpu_torch.ops import adm as adm_ops
    from turbo_metrics_tpu_torch.ops import vif as vif_ops

    if entry == "VIF":
        return vif_ops.vif_scores(sums.cpu().numpy())
    return adm_ops.adm_score(sums.cpu().numpy(), WIDE_HEIGHT, WIDE_WIDTH)


def describe_vmaf(entry: str, want) -> str:
    from turbo_metrics_tpu_torch.ops.vmaf_motion import motion_score

    shape = f"{WIDE_WIDTH}x{WIDE_HEIGHT} B={VMAF_WIDE_BATCH}"
    if entry in ("VIF", "ADM"):
        feats = vmaf_features(entry, want)
        return f"{shape} " + ", ".join(f"{k} {[round(float(x), 7) for x in v]}" for k, v in feats.items())
    if entry.startswith("motion"):
        sad = [int(v) for v in want["sad_rows"].sum(dim=-1).cpu()]
        return f"{shape} SAD {sad}, motion {[motion_score(v, WIDE_WIDTH, WIDE_HEIGHT) for v in sad]}"
    return f"{shape} blurred plane"


def check_vmaf_outputs(what: str, entry: str, got, want) -> tuple:
    """Phase 12 (a)/(c): VIF and ADM sums within VMAF_SUMS_RTOL and their
    features within VMAF_FEATURE_TOL; the blurred planes, row SADs and
    motion scores bit-equal.  Returns (each output's largest difference,
    what was equal)."""
    from turbo_metrics_tpu_torch.ops.vmaf_motion import motion_score

    for g, v in zip(output_tensors(got), output_tensors(want)):
        need(g.shape == v.shape and g.dtype == v.dtype, f"{what}: {tuple(g.shape)} {g.dtype}, "
             f"want {tuple(v.shape)} {v.dtype}")
    if entry in ("VIF", "ADM"):
        diffs = {"sums": check_close(f"{what}: sums", got.double(), want.double(), VMAF_SUMS_RTOL, 0.0)}
        diffs["sums_rel"] = float(((got.double() - want.double()).abs() / want.double().abs().clamp_min(1e-30)).max())
        f_got, f_want = vmaf_features(entry, got), vmaf_features(entry, want)
        for k, v in f_want.items():
            d = float(np.abs(f_got[k] - v).max())
            need(np.isfinite(f_got[k]).all() and d <= VMAF_FEATURE_TOL,
                 f"{what}: {k} {f_got[k]} vs unsharded {v} (bar {VMAF_FEATURE_TOL})")
            diffs[k] = d
        return diffs, f"features within {VMAF_FEATURE_TOL}"
    if entry.startswith("#17"):
        need(torch.equal(got, want), f"{what}: #17's plane differs from the unsharded call's")
        return {}, "plane bit-equal"
    for k in ("blurred", "sad_rows"):
        need(torch.equal(got[k], want[k]), f"{what}: {k} differs from the unsharded call's")
    scores = [motion_score(int(v), WIDE_WIDTH, WIDE_HEIGHT) for v in got["sad_rows"].sum(dim=-1).cpu()]
    want_scores = [motion_score(int(v), WIDE_WIDTH, WIDE_HEIGHT) for v in want["sad_rows"].sum(dim=-1).cpu()]
    need(scores == want_scores, f"{what}: motion {scores} vs unsharded {want_scores}")
    return {}, "blurred planes, row SADs and motion bit-equal"


def run_vmaf_configs(pair, motion_cases, mesh_of, card: str, label: str, strips=WIDTH_STRIPS,
                     host: bool = False, tag: str = "(12a)") -> dict:
    """Phase 12 (a) (and (c)): run_strip_entries of phase 12's entries."""
    return run_strip_entries(vmaf_entries(pair, motion_cases), vmaf_plan, check_vmaf_outputs, describe_vmaf,
                             mesh_of, card, label, strips, host, tag)


def check_vmaf_windows(dev, card: str) -> dict:
    """Phase 12 (b): #14, #15 (from the twin's emitted level 1, each scale's
    window from it), #16 and #18 with windows of owned columns that cut
    tiles mid-way (VMAF_WINDOW_CASES; #18 as a column strip of its frame
    where the case has one) against their twins on the same inputs at phase
    5c's bars (#14/#15 sums rtol 1e-4 / atol 1e-5, #14's emitted level rtol
    1e-5 / atol 1e-4, #18 sums rtol 1e-4, #16 bit for bit), and each with
    the full window bit-equal to no window.  Returns each wrapper's largest
    difference."""
    from turbo_metrics_tpu_torch.ops.adm import level_windows
    from turbo_metrics_tpu_torch.ops.kernels import adm, motion, vif

    g = torch.Generator(device=dev).manual_seed(37)
    errs = {"vif_scale0": 0.0, "vif_tail": 0.0, "adm_stats": 0.0, "motion_stats": 0.0}
    for what, h, w, frame_w, x0, cols, b in VMAF_WINDOW_CASES:
        ref = torch.randint(0, 256, (b, h, w), device=dev, generator=g)
        dis = (ref + torch.randint(-12, 13, ref.shape, device=dev, generator=g)).clamp(0, 255)
        p = torch.stack([ref, dis]).float().contiguous()
        y = ref.to(torch.uint8).contiguous()
        p0 = torch.randint(0, 1 << 16, (h, w), device=dev, generator=g).to(torch.int32).to(torch.uint16)
        s_k, l1_k = vif.vif_scale0(p, columns=cols)
        s_p, l1_p = vif.vif_scale0_ref(p, columns=cols)
        e14 = max(check_close(f"(12b) #14 {what} window {cols}", s_k, s_p, 1e-4, 1e-5),
                  check_close(f"(12b) #14 {what} level 1", l1_k, l1_p, 1e-5, 1e-4))
        cols1 = (-(-cols[0] // 2), -(-cols[1] // 2))
        t_k, t_p = vif.vif_tail(l1_p, columns=cols1), vif.vif_tail_ref(l1_p, columns=cols1)
        e15 = check_close(f"(12b) #15 {what} window {cols1}", t_k, t_p, 1e-4, 1e-5)
        full0, plain0 = vif.vif_scale0(p, columns=(0, w)), vif.vif_scale0(p)
        need(torch.equal(full0[0], plain0[0]) and torch.equal(full0[1], plain0[1])
             and torch.equal(vif.vif_tail(l1_p, columns=(0, l1_p.shape[-1])), vif.vif_tail(l1_p)),
             f"(12b) #14/#15 {what}: the full window differs from no window")
        frame = (x0, frame_w)
        a_k = adm.adm_stats(p, columns=cols, frame=frame)
        a_p = adm.adm_stats_ref(p, columns=cols, frame=frame)
        e18 = check_close(f"(12b) #18 {what} window {cols} at column {x0} of {frame_w}", a_k, a_p, 1e-4, 0.0)
        need(torch.equal(adm.adm_stats(p, columns=(0, w)), adm.adm_stats(p)),
             f"(12b) #18 {what}: the full window differs from no window")
        m_k, m_p = motion.motion_stats(y, p0, columns=cols), motion.motion_stats_ref(y, p0, columns=cols)
        need(torch.equal(m_k["blurred"].to(torch.int32), m_p["blurred"].to(torch.int32))
             and torch.equal(m_k["sad_rows"], m_p["sad_rows"]), f"(12b) #16 {what} window {cols}: differs from the twin")
        whole = motion.motion_stats(y, p0)
        full = motion.motion_stats(y, p0, columns=(0, w))
        need(all(torch.equal(full[k], whole[k]) for k in whole), f"(12b) #16 {what}: the full window differs")
        for k, e in (("vif_scale0", e14), ("vif_tail", e15), ("adm_stats", e18)):
            errs[k] = max(errs[k], e)
        rel18 = float(((a_k - a_p).abs() / a_p.abs().clamp_min(1e-30)).max())
        log(f"(12b) windowed kernels vs twins, {what} {w}x{h} B={b} (window {cols}; #18 at column {x0} of "
            f"{frame_w}, its windows {level_windows(w, cols, frame)}): #14 max abs {e14:.3g}, "
            f"#15 {e15:.3g}, #18 {e18:.3g} (rel {rel18:.3g}), #16 planes and row SADs equal; full windows "
            f"bit-equal to none [{card}]")
        del ref, dis, p, y, p0, l1_k, l1_p
    return errs


def run_vmaf_width_phase(dev, card: str) -> dict:
    """Phase 12: (a) every entry over 2, 4 and 8 strips of card 0, (b) the
    windowed #14, #15, #16 and #18 against their twins, (c) host inputs
    (every card where there are several), (d) the times and the peak
    memory."""
    from turbo_metrics_tpu_torch.parallel.mesh import make_mesh

    card0 = f"cuda:{dev.index or 0}"
    errs = check_vmaf_windows(dev, card)
    pair, motion_cases = wide_vmaf_inputs(dev)
    runs = run_vmaf_configs(pair, motion_cases, lambda n: make_mesh(n, device=card0), card, f"strips of {card0}")
    runs.update(run_strip_cards(lambda mesh_of, label, strips: run_vmaf_configs(
        pair, motion_cases, mesh_of, card, label, strips=strips, host=True, tag="(12c)"), "(12c)"))
    times = time_strip_entries(vmaf_entries(pair, motion_cases), lambda n: make_mesh(n, device=card0), card,
                               "(12d)", f"{WIDE_WIDTH}x{WIDE_HEIGHT} B={VMAF_WIDE_BATCH}")
    del pair, motion_cases
    return {"runs": runs, "window_err": errs, "times": times}


# Phase 13: width sharding of VMAF's fixed-point features (K-int-VIF,
# K-int-ADM), and the plain SSIM / MS-SSIM / XPSNR entries on their kernels
# (#11, #12, #13).  The integer sums at rtol 1e-6 and their features within
# 1e-6 over the strips (phase 12's bars), the plain entries' kernel routes
# at phase 5a's score bar against their "jnp" routes, XPSNR bit for bit.
INT_WIDE_BATCH = 2
# Plain entries, kernel route vs "jnp" route (phase 5a's score bar; TOL).
PLAIN_TOL = 1e-5
# (what, h, w, batch) of phase 13 (c)'s kernel-route checks: 1080p, and an
# edge size at which MS-SSIM's five levels clamp to three.
PLAIN_CASES = (("1080p", HEIGHT, WIDTH, BATCH), ("67x99", 67, 99, 2))


def wide_int_inputs(dev, seed: int = 41):
    """Phase 13 (a)'s seeded 7680x4320 B=2 pairs of luma codes, made on the
    card: (what, (2, B, h, w) pair, depth) for u8 codes (noise on a smooth
    base, the distorted copy within +-6) and 10-bit uint16 codes (the u8
    codes times 4 plus noise, the distorted copy within +-24)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w, b = WIDE_HEIGHT, WIDE_WIDTH, INT_WIDE_BATCH
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    base = 128 + 70 * torch.sin(xx / 9.0) * torch.cos(yy / 7.0)
    y8 = (base + 3 * torch.randn((b, h, w), device=dev, generator=g)).round().clamp(0, 255)
    d8 = (y8 + torch.randint(-6, 7, y8.shape, device=dev, generator=g)).clamp(0, 255)
    y10 = y8 * 4 + torch.randint(0, 4, y8.shape, device=dev, generator=g)
    d10 = (y10 + torch.randint(-24, 25, y10.shape, device=dev, generator=g)).clamp(0, 1023)
    pair8 = torch.stack([y8, d8]).to(torch.uint8).contiguous()
    pair10 = torch.stack([y10, d10]).to(torch.int32).to(torch.uint16).contiguous()
    return (("u8", pair8, 8), ("10-bit u16", pair10, 10))


def int_entries(int_cases):
    """(entry, function, inputs, in_ndims, launches per strip) of phase 13
    (a): integer_vif_stats and integer_adm_stats per pair, each counting one
    launch per scale or level."""
    import functools

    from turbo_metrics_tpu_torch.ops.kernels import integer_adm, integer_vif

    out = []
    for what, pair, depth in int_cases:
        out.append((f"K-int-VIF {what}", functools.partial(integer_vif.integer_vif_stats, depth=depth), (pair,),
                    (4,), {"integer_vif_stats": 4}))
        out.append((f"K-int-ADM {what}", functools.partial(integer_adm.integer_adm_stats, depth=depth), (pair,),
                    (4,), {"integer_adm_stats": 4}))
    return out


def int_plan(fn, mesh):
    """The strips shard_over_width cuts for ``fn`` (phase 13 (a)'s entries:
    VIF's plan or ADM's)."""
    from turbo_metrics_tpu_torch.ops.kernels import adm, integer_vif, vif
    from turbo_metrics_tpu_torch.parallel.mesh import spatial_sharding

    mod = vif if fn.func is integer_vif.integer_vif_stats else adm
    return spatial_sharding(mesh, WIDE_WIDTH, alignment=mod.STRIP_ALIGNMENT, halo=mod.STRIP_HALO)


def run_int_configs(int_cases, mesh_of, card: str, label: str, strips=WIDTH_STRIPS, host: bool = False,
                    tag: str = "(13a)") -> dict:
    """Phase 13 (a) (and (d)): run_strip_entries of the fixed-point
    entries, at phase 12's bars (check_vmaf_outputs)."""
    def feature(entry):
        return "VIF" if entry.startswith("K-int-VIF") else "ADM"

    return run_strip_entries(int_entries(int_cases), int_plan,
                             lambda what, entry, got, want: check_vmaf_outputs(what, feature(entry), got, want),
                             lambda entry, want: describe_vmaf(feature(entry), want), mesh_of, card, label, strips,
                             host, tag)


def check_int_windows(dev, card: str) -> dict:
    """Phase 13 (b): K-int-VIF and K-int-ADM with windows of owned columns
    that cut tiles mid-way (VMAF_WINDOW_CASES; K-int-ADM as a column strip
    of its frame where the case has one), u8 and 10-bit u16 codes, against
    their twins on the same inputs at phase 5j's bars (sums rtol 1e-6 and
    1e-5), and each with the full window bit-equal to no window.  Rows of
    whole 16-byte chunks take K-int-VIF's chunk loads and K-int-ADM's tensor
    copies, the odd widths their per-sample loads.  Returns each wrapper's
    largest difference."""
    from turbo_metrics_tpu_torch.ops.adm import level_windows
    from turbo_metrics_tpu_torch.ops.kernels import integer_adm, integer_vif

    g = torch.Generator(device=dev).manual_seed(43)
    errs = {"integer_vif_stats": 0.0, "integer_adm_stats": 0.0}
    paths = set()
    for what, h, w, frame_w, x0, cols, b in VMAF_WINDOW_CASES:
        for depth, dt in ((8, torch.uint8), (10, torch.uint16)):
            top = 1 << depth
            ref = torch.randint(0, top, (b, h, w), device=dev, generator=g)
            dis = (ref + torch.randint(-(top >> 4), (top >> 4) + 1, ref.shape, device=dev, generator=g))
            pair = torch.stack([ref, dis.clamp(0, top - 1)]).to(torch.int32).to(dt).contiguous()
            del ref, dis
            chunks = (w * pair.element_size()) % 16 == 0
            paths.add(chunks)
            v_k = integer_vif.integer_vif_stats(pair, depth=depth, columns=cols)
            v_p = integer_vif.integer_vif_stats_ref(pair, depth=depth, columns=cols)
            e_v = check_close(f"(13b) K-int-VIF {what} {depth}-bit window {cols}", v_k, v_p, 1e-6, 0.0)
            frame = (x0, frame_w)
            a_k = integer_adm.integer_adm_stats(pair, depth=depth, columns=cols, frame=frame)
            a_p = integer_adm.integer_adm_stats_ref(pair, depth=depth, columns=cols, frame=frame)
            e_a = check_close(f"(13b) K-int-ADM {what} {depth}-bit window {cols} at column {x0} of {frame_w}",
                              a_k, a_p, 1e-5, 0.0)
            need(torch.equal(integer_vif.integer_vif_stats(pair, depth=depth, columns=(0, w)),
                             integer_vif.integer_vif_stats(pair, depth=depth))
                 and torch.equal(integer_adm.integer_adm_stats(pair, depth=depth, columns=(0, w)),
                                 integer_adm.integer_adm_stats(pair, depth=depth)),
                 f"(13b) K-int {what} {depth}-bit: the full window differs from no window")
            errs["integer_vif_stats"] = max(errs["integer_vif_stats"], e_v)
            errs["integer_adm_stats"] = max(errs["integer_adm_stats"], e_a)
            rel_v = float(((v_k - v_p).abs() / v_p.abs().clamp_min(1e-30)).max())
            rel_a = float(((a_k - a_p).abs() / a_p.abs().clamp_min(1e-30)).max())
            log(f"(13b) windowed K-int vs twins, {what} {w}x{h} B={b} {depth}-bit {str(pair.dtype)[6:]} (window "
                f"{cols}; K-int-ADM at column {x0} of {frame_w}, its windows {level_windows(w, cols, frame)}; "
                + ("chunk loads / tensor copies" if chunks else "per-sample loads")
                + f"): K-int-VIF max abs {e_v:.3g} (rel {rel_v:.3g}), K-int-ADM {e_a:.3g} (rel {rel_a:.3g}); full "
                f"windows bit-equal to none [{card}]")
            del pair
    need(paths == {True, False}, f"(13b) the cases took only {'the chunk' if True in paths else 'the sample'} loads")
    return errs


def plain_launches(fn, *args, **kw) -> tuple:
    """(fn's result, the wrappers it launched), counters reset just before
    and read just after."""
    reset_counts()
    out = fn(*args, **kw)
    return out, {k: v for k, v in read_counts().items() if v}


def plain_outputs(entry: str, out) -> dict:
    """An entry's result as {output name: tensor}."""
    if isinstance(out, dict):
        return out
    if isinstance(out, tuple):
        return {"ssim": out[0], "msssim": out[1]}
    return {"msssim" if "MS-SSIM" in entry else "ssim": out}


def check_plain_entries(dev, card: str) -> dict:
    """Phase 13 (c), unsharded: ssim, msssim (5 levels, clamped to 3 at
    67x99, and 3) and ssim_msssim with backend "auto" on CUDA tensors
    against "jnp" on the same tensors (PLAIN_CASES: PLAIN_TOL; #11 and #12
    launched by "auto", none by "jnp"); xpsnr_ops.xpsnr_block_stats with a
    seeded per-frame y_prev, "auto" (#13) bit-equal to "jnp", and with
    y_prev[b] = y_ref[b-1] bit-equal to the kernel wrapper's prev0
    convention; and each of JAX's gates sending the call to the plain route
    (no launch): one channel, a dim under 11, block 8, a y_prev of another
    type, 4-D planes.  Returns the largest differences."""
    import functools

    from turbo_metrics_tpu_torch.ops import quality, xpsnr_ops
    from turbo_metrics_tpu_torch.ops.kernels import xpsnr

    g = torch.Generator(device=dev).manual_seed(47)
    errs = {"ssim": 0.0, "msssim": 0.0}
    entries = (("SSIM", quality.ssim, 1), ("MS-SSIM", quality.msssim, 5),
               ("MS-SSIM levels=3", functools.partial(quality.msssim, levels=3), 3),
               ("SSIM/MS-SSIM", quality.ssim_msssim, 5))
    for what, h, w, b in PLAIN_CASES:
        a = torch.randint(0, 256, (b, 3, h, w), device=dev, generator=g).float()
        c = (a + torch.randint(-15, 16, a.shape, device=dev, generator=g)).clamp(0, 255)
        line = []
        for name, fn, levels in entries:
            lv = quality._clamp_levels(h, w, levels)[0]
            got, k_launch = plain_launches(fn, a, c, backend="auto")
            want, p_launch = plain_launches(fn, a, c, backend="jnp")
            expect = {"ssim_sums": 1, **({"msssim_tail": 1} if lv > 1 else {})}
            need(k_launch == expect, f"(13c) {name} {what} auto: launches {k_launch}, want {expect}")
            need(not p_launch, f"(13c) {name} {what} jnp: launched {p_launch}")
            got, want = plain_outputs(name, got), plain_outputs(name, want)
            for k in want:
                d = float((got[k] - want[k]).abs().max())
                need(bool(torch.isfinite(got[k]).all()) and d <= PLAIN_TOL,
                     f"(13c) {name} {what} {k}: kernels {got[k].tolist()} vs plain {want[k].tolist()}")
                errs[k] = max(errs[k], d)
                line.append(f"{name} {k} {d:.3g}")
            line[-1] += f" ({lv} levels, launches {k_launch})"
        log(f"(13c) plain entries {w}x{h} B={b}, backend auto (#11/#12) vs jnp on the same CUDA tensors, max |diff|: "
            + "; ".join(line) + f" [{card}]")
    # JAX's gates: the plain route, no launch (a dim under 11 leaves no valid
    # output: NaN means on both routes).
    one = torch.randint(0, 256, (2, 2, 40, 48), device=dev, generator=g).float()
    thin = torch.randint(0, 256, (2, 6, 40, 10), device=dev, generator=g).float()
    for what, x, y in (("one channel", one[:, :1].contiguous(), one[:, 1:].contiguous()),
                       ("a dim under 11", thin[:, :3].contiguous(), thin[:, 3:].contiguous())):
        for name, fn, _ in entries:
            got, launched = plain_launches(fn, x, y, backend="auto")
            want = fn(x, y, backend="jnp")
            need(not launched, f"(13c) gate {what}: {name} launched {launched}")
            got, want = plain_outputs(name, got), plain_outputs(name, want)
            need(all(torch.allclose(got[k], want[k], rtol=0, atol=0, equal_nan=True) for k in want),
                 f"(13c) gate {what}: {name} differs from jnp")
    xp = {}
    for what, h, w, b, dt, depth in (("1080p u8", HEIGHT, WIDTH, BATCH, torch.uint8, 8),
                                     ("1080p 10-bit u16", HEIGHT, WIDTH, BATCH, torch.uint16, 10),
                                     ("17x33 u8", 17, 33, 3, torch.uint8, 8)):
        y, d, p = (torch.randint(0, 1 << depth, (b, h, w), device=dev, generator=g).to(torch.int32).to(dt)
                   for _ in range(3))
        got, k_launch = plain_launches(xpsnr_ops.xpsnr_block_stats, y, d, p, depth=depth)
        want, p_launch = plain_launches(xpsnr_ops.xpsnr_block_stats, y, d, p, depth=depth, backend="jnp")
        need(k_launch == {"xpsnr_block_stats": 1} and not p_launch,
             f"(13c) XPSNR {what}: launches {k_launch} (auto), {p_launch} (jnp)")
        need(all(torch.equal(got[q], want[q]) for q in want), f"(13c) XPSNR {what}: per-frame y_prev differs from jnp")
        # In int32: torch's uint16 tensors take few operations on CUDA.
        prev = torch.cat([p[:1].to(torch.int32), y[:-1].to(torch.int32)]).to(dt)
        conv = xpsnr.xpsnr_block_stats(y, d, p[0].contiguous())
        got2 = xpsnr_ops.xpsnr_block_stats(y, d, prev, depth=depth)
        need(all(torch.equal(got2[q], conv[q]) for q in conv),
             f"(13c) XPSNR {what}: y_prev[b] = y_ref[b-1] differs from the prev0 convention")
        xp[what] = True
        log(f"(13c) XPSNR {what} B={b}: per-frame y_prev through #13 (launches {k_launch}) bit-equal to jnp, and "
            f"with y_prev[b] = y_ref[b-1] to xpsnr_block_stats(prev0=...) [{card}]")
    y, d, p = (torch.randint(0, 256, (2, 40, 64), device=dev, generator=g).to(torch.uint8) for _ in range(3))
    for what, args, kw in (("block 8", (y, d, p), {"block": 8}),
                           ("y_prev of another type", (y, d, p.to(torch.int32)), {}),
                           ("4-D planes", (y[None], d[None], p[None]), {})):
        got, launched = plain_launches(xpsnr_ops.xpsnr_block_stats, *args, **kw)
        want = xpsnr_ops.xpsnr_block_stats(*args, **kw, backend="jnp")
        need(not launched and all(torch.equal(got[q], want[q]) for q in want),
             f"(13c) XPSNR gate {what}: launched {launched} or differs from jnp")
    log(f"(13c) JAX's gates (one channel, a dim under 11; XPSNR block 8, a y_prev of another type, 4-D planes) "
        f"take the plain route: no launch, equal to jnp [{card}]")
    return {**errs, "xpsnr_prev_equal": all(xp.values())}


def wide_plain_inputs(dev, seed: int = 53):
    """Phase 13 (c)'s seeded 7680x4320 B=1 inputs, made on the card: a pair
    of (1, 3, h, w) f32 code values (noise on a smooth base, the distorted
    copy within +-9), and u8 luma y_ref, y_dis and a per-frame y_prev."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w = WIDE_HEIGHT, WIDE_WIDTH
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    base = 128 + 70 * torch.sin(xx / 9.0) * torch.cos(yy / 7.0)
    a = (base + 4 * torch.randn((1, 3, h, w), device=dev, generator=g)).round().clamp(0, 255)
    b = (a + torch.randint(-9, 10, a.shape, device=dev, generator=g)).clamp(0, 255)
    y = a[:, 1].to(torch.uint8).contiguous()
    d = b[:, 1].to(torch.uint8).contiguous()
    p = torch.roll(y, 3, dims=-1).contiguous()
    return (a, b), (y, d, p)


def plain_entries(codes, luma):
    """(entry, function, inputs, in_ndims, launches per strip) of phase 13
    (c)'s sharded calls: ssim, msssim, ssim_msssim and the plain XPSNR
    statistics with a per-frame y_prev."""
    from turbo_metrics_tpu_torch.ops import quality, xpsnr_ops

    both = {"ssim_sums": 1, "msssim_tail": 1}
    return [("SSIM", quality.ssim, codes, (4, 4), {"ssim_sums": 1}),
            ("MS-SSIM", quality.msssim, codes, (4, 4), both),
            ("SSIM/MS-SSIM", quality.ssim_msssim, codes, (4, 4), both),
            ("XPSNR per-frame y_prev u8", xpsnr_ops.xpsnr_block_stats, luma, (3, 3, 3), {"xpsnr_block_stats": 1})]


def plain_plan(fn, mesh):
    """The strips shard_over_width cuts for ``fn`` (phase 13 (c)'s sharded
    entries)."""
    from turbo_metrics_tpu_torch.ops import quality
    from turbo_metrics_tpu_torch.parallel.mesh import spatial_sharding

    if fn is quality.ssim:
        return spatial_sharding(mesh, WIDE_WIDTH, num_scales=1)
    if fn in (quality.msssim, quality.ssim_msssim):
        return spatial_sharding(mesh, WIDE_WIDTH, num_scales=quality._clamp_levels(WIDE_HEIGHT, WIDE_WIDTH, 5)[0])
    return spatial_sharding(mesh, WIDE_WIDTH, alignment=16, halo=16)


def run_plain_configs(codes, luma, mesh_of, card: str, label: str, strips=WIDTH_STRIPS, host: bool = False,
                      tag: str = "(13c)") -> dict:
    """Phase 13 (c) (and (d)), sharded: run_strip_entries of the plain
    entries at 8K B=1, SSIM and MS-SSIM within METRIC_TOL of unsharded,
    XPSNR grids and dB bit-equal (check_metric_outputs)."""
    def describe(entry, want):
        out = plain_outputs(entry, want)
        if entry.startswith("XPSNR"):
            return f"{WIDE_WIDTH}x{WIDE_HEIGHT} B=1 XPSNR {xpsnr_db_of(out, 8)[0]!r} dB"
        return f"{WIDE_WIDTH}x{WIDE_HEIGHT} B=1 " + ", ".join(f"{k} {v.tolist()}" for k, v in out.items())

    def check(what, entry, got, want):
        diffs = check_metric_outputs(what, entry, plain_outputs(entry, got), plain_outputs(entry, want), 8)
        return diffs, "grids and dB bit-equal" if entry.startswith("XPSNR") else f"within {METRIC_TOL}"

    return run_strip_entries(plain_entries(codes, luma), plain_plan, check, describe, mesh_of, card, label, strips,
                             host, tag)


def time_plain_routes(dev, card: str) -> dict:
    """Phase 13 (e): each plain entry's kernel route against its "jnp" route
    at 1080p B=8 (CUDA events, auto / jnp / jnp / auto), its peak memory
    above the inputs, and the copy that stacks a and b into #11's pair."""
    import functools

    from turbo_metrics_tpu_torch.ops import quality, xpsnr_ops
    from turbo_metrics_tpu_torch.utils.profiling import time_ms

    g = torch.Generator(device=dev).manual_seed(59)
    a = torch.randint(0, 256, (BATCH, 3, HEIGHT, WIDTH), device=dev, generator=g).float()
    c = (a + torch.randint(-15, 16, a.shape, device=dev, generator=g)).clamp(0, 255)
    y, d, p = (torch.randint(0, 256, (BATCH, HEIGHT, WIDTH), device=dev, generator=g).to(torch.uint8)
               for _ in range(3))
    out = {}
    for name, fn, args in (("ssim", quality.ssim, (a, c)), ("msssim", quality.msssim, (a, c)),
                           ("ssim_msssim", quality.ssim_msssim, (a, c)),
                           ("xpsnr_ops.xpsnr_block_stats", xpsnr_ops.xpsnr_block_stats, (y, d, p))):
        runs = {"auto": [], "jnp": []}
        for backend in ("auto", "jnp", "jnp", "auto"):
            runs[backend].append(time_ms(functools.partial(fn, *args, backend=backend), 5 if backend == "auto" else 2,
                                         dev))
        peak = {k: step_peak_mib(functools.partial(fn, *args, backend=k), dev) for k in runs}
        out[name] = {"ms": runs, "peak_mib": peak}
        log(f"(13e) {name} {WIDTH}x{HEIGHT} B={BATCH}: kernel route " + " / ".join(f"{t:.4f}" for t in runs["auto"])
            + " ms, jnp route " + " / ".join(f"{t:.3f}" for t in runs["jnp"]) + " ms (CUDA events, one call); peak "
            f"above the inputs {peak['auto']:.1f} / {peak['jnp']:.1f} MiB [{card}]")
    stack_ms = time_ms(lambda: torch.stack([a, c]), 5, dev)
    out["pair copy"] = stack_ms
    log(f"(13e) the pair copy of the kernel route (torch.stack of a and c, {2 * a.numel() * 4 / 1e6:.0f} MB "
        f"written): {stack_ms:.4f} ms [{card}]")
    return out


def run_int_plain_phase(dev, card: str) -> dict:
    """Phase 13: (a) the fixed-point entries over 2, 4 and 8 strips of card
    0, (b) the windowed K-int-VIF and K-int-ADM against their twins, (c)
    the plain entries on their kernels, unsharded and over the strips, (d)
    host inputs (every card where there are several), (e) the times and
    the peak memory."""
    from turbo_metrics_tpu_torch.parallel.mesh import make_mesh

    card0 = f"cuda:{dev.index or 0}"
    strips_of = lambda n: make_mesh(n, device=card0)  # noqa: E731
    errs = check_int_windows(dev, card)
    plain = check_plain_entries(dev, card)
    int_cases = wide_int_inputs(dev)
    runs = run_int_configs(int_cases, strips_of, card, f"strips of {card0}")
    runs.update(run_strip_cards(lambda mesh_of, label, strips: run_int_configs(
        int_cases, mesh_of, card, label, strips=strips, host=True, tag="(13d)"), "(13d)"))
    times = time_strip_entries(int_entries(int_cases), strips_of, card, "(13e)",
                               f"{WIDE_WIDTH}x{WIDE_HEIGHT} B={INT_WIDE_BATCH}")
    del int_cases
    codes, luma = wide_plain_inputs(dev)
    runs.update(run_plain_configs(codes, luma, strips_of, card, f"strips of {card0}"))
    runs.update(run_strip_cards(lambda mesh_of, label, strips: run_plain_configs(
        codes, luma, mesh_of, card, label, strips=strips, host=True, tag="(13d)"), "(13d)"))
    times.update(time_strip_entries(plain_entries(codes, luma), strips_of, card, "(13e)",
                                    f"{WIDE_WIDTH}x{WIDE_HEIGHT} B=1"))
    del codes, luma
    times["routes"] = time_plain_routes(dev, card)
    return {"runs": runs, "window_err": errs, "plain": plain, "times": times}


# Phase 14: the plain VMAF-feature and conversion entries on their kernels
# (ops/vif.py vif_scale_stats and ops/adm.py adm_stats with backend,
# integer and depth; ops/vmaf_motion.py integer_blur and motion_stats; ops/
# colorspace.py yuv420_to_linear_rgb), #16 with every frame's own previous
# plane, and the plain VIF, ADM and motion entries over strips.  Each route
# against its "jnp" route on the same CUDA tensors at phase 5c's bars (VIF
# features 1e-5, ADM's 1e-4, the sums rtol 1e-4), the fixed-point sums at
# phase 13 (b)'s (rtol 1e-6 VIF, 1e-5 ADM), motion and the blur bit for bit,
# the conversion at phase 5b's (atol 1e-6; PQ 1e-4); the strips at phase
# 12's.
PLAIN_VMAF_CASES = (("1080p", HEIGHT, WIDTH, BATCH), ("67x99", 67, 99, 2))


def plain_vmaf_inputs(dev, h: int, w: int, b: int, seed: int) -> dict:
    """Seeded inputs of phase 14 at h x w, B frames, made on the card: u8
    luma codes (noise on a smooth base) and a distorted copy within +-6, the
    same as 10-bit u16 codes (times 4 plus noise, +-24), their f32 values,
    per-frame previous blurred planes (seeded uint16, none the blur of the
    frame before), 8-bit 4:2:0 and 10-bit 4:2:2 chroma."""
    g = torch.Generator(device=dev).manual_seed(seed)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    base = 128 + 70 * torch.sin(xx / 9.0) * torch.cos(yy / 7.0)
    y8 = (base + 3 * torch.randn((b, h, w), device=dev, generator=g)).round().clamp(0, 255)
    d8 = (y8 + torch.randint(-6, 7, y8.shape, device=dev, generator=g)).clamp(0, 255)
    y10 = y8 * 4 + torch.randint(0, 4, y8.shape, device=dev, generator=g)
    d10 = (y10 + torch.randint(-24, 25, y10.shape, device=dev, generator=g)).clamp(0, 1023)

    def u16(t):
        return t.to(torch.int32).to(torch.uint16).contiguous()

    def rand(shape, top):
        return torch.randint(0, top, shape, device=dev, generator=g, dtype=torch.int32)

    return {"r8": y8.to(torch.uint8).contiguous(), "d8": d8.to(torch.uint8).contiguous(),
            "r10": u16(y10), "d10": u16(d10), "rf": y8.contiguous(), "df": d8.contiguous(),
            "prev": u16(rand((b, h, w), 1 << 16)),
            "uv420": rand((b, (h + 1) // 2, (w + 1) // 2, 2), 256).to(torch.uint8).contiguous(),
            "uv422": u16(rand((b, h, (w + 1) // 2, 2), 1024))}


def plain_vmaf_routes(x: dict) -> list:
    """(entry, call of a backend, the launches of its kernel route, its
    kind: the bar check_plain_route holds it to) of phase 14 (a)."""
    from turbo_metrics_tpu_torch.ops import adm, colorspace, vif, vmaf_motion

    ivif, iadm = {"integer_vif_stats": 4}, {"integer_adm_stats": 4}
    return [
        ("VIF", lambda b: vif.vif_scale_stats(x["rf"], x["df"], backend=b), {"vif_scale0": 1, "vif_tail": 1}, "VIF"),
        ("VIF integer u8", lambda b: vif.vif_scale_stats(x["r8"], x["d8"], integer=True, backend=b), ivif,
         "VIF integer"),
        ("VIF integer 10-bit", lambda b: vif.vif_scale_stats(x["r10"], x["d10"], integer=True, depth=10,
                                                             backend=b), ivif, "VIF integer"),
        ("ADM", lambda b: adm.adm_stats(x["rf"], x["df"], backend=b), {"adm_stats": 1}, "ADM"),
        ("ADM integer u8", lambda b: adm.adm_stats(x["r8"], x["d8"], integer=True, backend=b), iadm, "ADM integer"),
        ("ADM integer 10-bit", lambda b: adm.adm_stats(x["r10"], x["d10"], integer=True, depth=10, backend=b), iadm,
         "ADM integer"),
        ("integer_blur 10-bit", lambda b: vmaf_motion.integer_blur(x["r10"], depth=10, backend=b),
         {"integer_blur": 1}, "exact"),
        ("motion_stats u8, per-frame prev", lambda b: vmaf_motion.motion_stats(x["r8"], x["prev"], backend=b),
         {"motion_stats": 1}, "exact"),
        ("motion_stats 10-bit, one prev", lambda b: vmaf_motion.motion_stats(x["r10"], x["prev"][0], depth=10,
                                                                             backend=b), {"motion_stats": 1},
         "exact"),
        ("conversion 8-bit 4:2:0", lambda b: colorspace.yuv420_to_linear_rgb(x["r8"], x["uv420"], backend=b),
         {"yuv_to_linear_rgb": 1}, "conversion"),
        ("conversion 10-bit 4:2:2 PQ", lambda b: colorspace.yuv420_to_linear_rgb(
            x["r10"], x["uv422"], depth=10, matrix="bt2020", transfer="pq", chroma=422, backend=b),
         {"yuv_to_linear_rgb": 1}, "conversion PQ"),
    ]


def check_plain_route(what: str, kind: str, got, want, h: int, w: int) -> float:
    """Phase 14 (a): the kernel route's result against the "jnp" route's at
    the bar of its kind.  Returns the largest difference (0 where bit for
    bit is asked)."""
    from turbo_metrics_tpu_torch.ops import adm as adm_ops
    from turbo_metrics_tpu_torch.ops import vif as vif_ops

    for g, v in zip(output_tensors(got), output_tensors(want)):
        need(g.shape == v.shape and g.dtype == v.dtype and bool(torch.isfinite(g.float()).all()),
             f"{what}: {tuple(g.shape)} {g.dtype} vs the jnp route's {tuple(v.shape)} {v.dtype}")
    if kind == "exact":
        need(all(torch.equal(g, v) for g, v in zip(output_tensors(got), output_tensors(want))),
             f"{what}: differs from the jnp route")
        return 0.0
    if kind.startswith("conversion"):
        return check_close(what, got, want, 0.0, 1e-4 if kind.endswith("PQ") else 1e-6)
    if kind.endswith("integer"):
        return check_close(f"{what}: sums", got, want, 1e-6 if kind.startswith("VIF") else 1e-5, 0.0)
    err = check_close(f"{what}: sums", got, want, 1e-4, 1e-5 if kind == "VIF" else 0.0)
    if kind == "VIF":
        f_got, f_want, bar = vif_ops.vif_scores(got.cpu().numpy()), vif_ops.vif_scores(want.cpu().numpy()), 1e-5
    else:
        f_got, f_want = (adm_ops.adm_score(t.cpu().numpy(), h, w) for t in (got, want))
        bar = 1e-4
    for k, v in f_want.items():
        d = float(np.abs(f_got[k] - v).max())
        need(d <= bar, f"{what}: {k} {f_got[k]} vs the jnp route's {v} (bar {bar})")
    return err


def check_plain_vmaf(dev, card: str) -> dict:
    """Phase 14 (a): every plain entry with backend None (the kernels on a
    CUDA tensor) against "jnp" on the same tensors (PLAIN_VMAF_CASES), the
    launches of each ("jnp" none); JAX's gates and the kernels' types
    sending a call to the plain route without a launch.  Returns each
    entry's largest difference."""
    from turbo_metrics_tpu_torch.ops import adm, colorspace, vif, vmaf_motion

    errs = {}
    for i, (case, h, w, b) in enumerate(PLAIN_VMAF_CASES):
        x = plain_vmaf_inputs(dev, h, w, b, 61 + i)
        line = []
        for entry, call, launches, kind in plain_vmaf_routes(x):
            got, k_launch = plain_launches(call, None)
            want, p_launch = plain_launches(call, "jnp")
            need(k_launch == launches, f"(14a) {entry} {case}: launches {k_launch}, want {launches}")
            need(not p_launch, f"(14a) {entry} {case} jnp: launched {p_launch}")
            d = check_plain_route(f"(14a) {entry} {case}", kind, got, want, h, w)
            errs[entry] = max(errs.get(entry, 0.0), d)
            line.append(f"{entry} {d:.3g} {k_launch}")
        log(f"(14a) plain entries {w}x{h} B={b}, backend None (the kernels) vs jnp on the same CUDA tensors, max "
            "|diff| and launches: " + "; ".join(line) + f" [{card}]")
    x = plain_vmaf_inputs(dev, 31, 64, 2, 67)
    wide = plain_vmaf_inputs(dev, 40, 64, 2, 71)
    gates = [
        ("VIF, a side of 31", lambda b: vif.vif_scale_stats(x["rf"], x["df"], backend=b)),
        ("ADM, a side of 31", lambda b: adm.adm_stats(x["rf"], x["df"], backend=b)),
        ("#17, a side of 31", lambda b: vmaf_motion.integer_blur(x["r8"], backend=b)),
        ("#16, a side of 31", lambda b: vmaf_motion.motion_stats(x["r8"], x["prev"], backend=b)),
        ("VIF integer, 2-D planes", lambda b: vif.vif_scale_stats(wide["r8"][0], wide["d8"][0], integer=True,
                                                                 backend=b)),
        ("ADM, windows", lambda b: adm.adm_stats(wide["rf"], wide["df"], windows=adm.level_windows(64),
                                                  backend=b)),
        ("#17, int64 luma", lambda b: vmaf_motion.integer_blur(wide["r8"].to(torch.int64), backend=b)),
        ("#16, int32 previous planes", lambda b: vmaf_motion.motion_stats(wide["r8"], wide["prev"].to(torch.int32),
                                                                          backend=b)),
        ("#5, a (2, B, h, w) pair", lambda b: colorspace.yuv420_to_linear_rgb(
            torch.stack([wide["r8"], wide["d8"]]), torch.stack([wide["uv420"], wide["uv420"]]), backend=b)),
        ("#5, uint16 at 8 bits", lambda b: colorspace.yuv420_to_linear_rgb(
            wide["r8"].to(torch.int32).to(torch.uint16), wide["uv420"].to(torch.int32).to(torch.uint16),
            backend=b)),
    ]
    for what, call in gates:
        got, launched = plain_launches(call, None)
        want = call("jnp")
        need(not launched, f"(14a) gate {what}: launched {launched}")
        need(all(torch.equal(g, v) for g, v in zip(output_tensors(got), output_tensors(want))),
             f"(14a) gate {what}: differs from jnp")
    log("(14a) JAX's gates and the kernels' types (a side of 31, 2-D planes, ADM's windows, int64 luma, int32 "
        f"previous planes, a (2, B, h, w) conversion pair, uint16 at 8 bits) take the plain route: no launch, "
        f"equal to jnp [{card}]")
    return errs


def check_motion_prev(dev, card: str) -> dict:
    """Phase 14 (b): #16 with every frame's own previous plane (``prev``,
    seeded planes, none the blur of the frame before; and one plane for
    every frame, a batch stride of 0) bit-equal to its twin and to the
    plain route, at 1080p B=8 u8 and 10-bit u16, 67x99 10-bit and int32
    codes; ``prev`` = [prev0, blur of frames 0 .. B-2] bit-equal to the
    prev0 convention (the engine's chained calls); the per-frame call's
    time beside the chained call's at 1080p u8 B=8.  Returns the times."""
    from turbo_metrics_tpu_torch.ops import vmaf_motion
    from turbo_metrics_tpu_torch.ops.kernels import motion
    from turbo_metrics_tpu_torch.utils.profiling import time_ms

    g = torch.Generator(device=dev).manual_seed(73)
    out = {}
    for what, (b, h, w), depth, dt in (("1080p u8", (BATCH, HEIGHT, WIDTH), 8, torch.uint8),
                                       ("1080p 10-bit u16", (BATCH, HEIGHT, WIDTH), 10, torch.uint16),
                                       ("67x99 10-bit u16", (3, 67, 99), 10, torch.uint16),
                                       ("67x99 10-bit int32 codes", (3, 67, 99), 10, torch.int32)):
        y = torch.randint(0, 1 << depth, (b, h, w), device=dev, generator=g, dtype=torch.int32).to(dt)
        prev = torch.randint(0, 1 << 16, (b, h, w), device=dev, generator=g, dtype=torch.int32).to(torch.uint16)
        reset_counts()
        got = motion.motion_stats(y, prev=prev, depth=depth)
        n = read_counts()["motion_stats"]
        need(n == 1, f"(14b) #16 per-frame prev {what}: {n} launches")
        for name, want in (("its twin", motion.motion_stats_ref(y, prev=prev, depth=depth)),
                           ("the plain route", vmaf_motion.motion_stats(y, prev, depth=depth, backend="jnp"))):
            need(all(torch.equal(got[q], want[q]) for q in want), f"(14b) #16 per-frame prev {what}: differs from "
                 f"{name}")
        one = motion.motion_stats(y, prev=prev[1].expand(y.shape), depth=depth)
        want = vmaf_motion.motion_stats(y, prev[1], depth=depth, backend="jnp")
        need(all(torch.equal(one[q], want[q]) for q in want), f"(14b) #16 one prev for every frame {what}")
        chained = motion.motion_stats(y, prev[0].contiguous(), depth=depth)
        # In int32: torch's uint16 tensors take few operations on CUDA.
        carried = torch.cat([prev[:1].to(torch.int32), got["blurred"][:-1].to(torch.int32)]).to(torch.uint16)
        same = motion.motion_stats(y, prev=carried, depth=depth)
        need(all(torch.equal(chained[q], same[q]) for q in same),
             f"(14b) #16 {what}: prev = [prev0, blur of frames 0 .. B-2] differs from the prev0 convention")
        log(f"(14b) #16 per-frame prev {what} B={b}: bit-equal to its twin and to the plain route, one plane for "
            f"every frame too; [prev0, blur of frames 0 .. B-2] bit-equal to prev0 [{card}]")
        if what == "1080p u8":
            runs = {"per-frame prev": [], "prev0": []}
            for k in ("prev0", "per-frame prev", "per-frame prev", "prev0"):
                runs[k].append(time_ms(lambda: motion.motion_stats(y, prev=prev) if k == "per-frame prev"
                                       else motion.motion_stats(y, prev[0].contiguous()), 20, dev))
            out = runs
            log(f"(14b) #16 1080p u8 B={BATCH}: per-frame prev " + " / ".join(f"{t:.4f}" for t in runs["per-frame prev"])
                + " ms, prev0 " + " / ".join(f"{t:.4f}" for t in runs["prev0"]) + f" ms (CUDA events) [{card}]")
    return out


def plain_vmaf_strip_entries(pair, motion_cases):
    """(entry, function, inputs, in_ndims, launches per strip) of phase 14
    (c): the plain VIF and ADM entries on phase 12's 8K pair (its f32
    planes), the plain motion_stats with per-frame previous planes (the
    luma rolled by 3 columns and blurred) and integer_blur on its luma."""
    import functools

    from turbo_metrics_tpu_torch.ops import adm, vif, vmaf_motion
    from turbo_metrics_tpu_torch.ops.kernels import motion

    out = [("VIF", vif.vif_scale_stats, (pair[0], pair[1]), (3, 3), {"vif_scale0": 1, "vif_tail": 1}),
           ("ADM", adm.adm_stats, (pair[0], pair[1]), (3, 3), {"adm_stats": 1})]
    for what, y, _, depth in motion_cases:
        prev = motion.integer_blur(torch.roll(y, 3, dims=-1).contiguous(), depth=depth)
        out.append((f"motion {what}, per-frame prev", functools.partial(vmaf_motion.motion_stats, depth=depth),
                    (y, prev), (3, 3), {"motion_stats": 1}))
        out.append((f"#17 {what}", functools.partial(vmaf_motion.integer_blur, depth=depth), (y,), (3,),
                    {"integer_blur": 1}))
    return out


def plain_vmaf_plan(fn, mesh):
    """The strips shard_over_width cuts for ``fn`` (phase 14 (c)'s entries)."""
    from turbo_metrics_tpu_torch.ops import adm, vif
    from turbo_metrics_tpu_torch.ops.kernels import adm as k_adm
    from turbo_metrics_tpu_torch.ops.kernels import motion as k_motion
    from turbo_metrics_tpu_torch.ops.kernels import vif as k_vif
    from turbo_metrics_tpu_torch.parallel.mesh import spatial_sharding

    base = getattr(fn, "func", fn)
    mod = k_vif if base is vif.vif_scale_stats else k_adm if base is adm.adm_stats else k_motion
    return spatial_sharding(mesh, WIDE_WIDTH, alignment=mod.STRIP_ALIGNMENT, halo=mod.STRIP_HALO)


def time_plain_vmaf(dev, card: str) -> dict:
    """Phase 14 (d): each plain entry's kernel route (None) against its
    "jnp" route at 1080p B=8 by CUDA events (None / jnp / jnp / None), with
    the stacked pair copy of VIF's and ADM's kernel route."""
    import functools

    from turbo_metrics_tpu_torch.ops import routes
    from turbo_metrics_tpu_torch.utils.profiling import time_ms

    x = plain_vmaf_inputs(dev, HEIGHT, WIDTH, BATCH, 79)
    out = {}
    for entry, call, _, _ in plain_vmaf_routes(x):
        runs = {"kernels": [], "jnp": []}
        for backend in (None, "jnp", "jnp", None):
            runs["kernels" if backend is None else "jnp"].append(
                time_ms(functools.partial(call, backend), 5 if backend is None else 2, dev))
        out[entry] = runs
        log(f"(14d) {entry} {WIDTH}x{HEIGHT} B={BATCH}: kernel route " + " / ".join(f"{t:.4f}" for t in runs["kernels"])
            + " ms, jnp route " + " / ".join(f"{t:.3f}" for t in runs["jnp"]) + f" ms (CUDA events, one call) [{card}]")
    out["pair copy"] = time_ms(lambda: routes.f32_pair(x["rf"], x["df"]), 5, dev)
    log(f"(14d) the f32 pair copy of VIF's and ADM's kernel route ({2 * x['rf'].numel() * 4 / 1e6:.0f} MB "
        f"written): {out['pair copy']:.4f} ms [{card}]")
    return out


def run_plain_vmaf_phase(dev, card: str) -> dict:
    """Phase 14: (a) the plain VMAF-feature and conversion entries on their
    kernels against their "jnp" routes, and JAX's gates; (b) #16 with
    every frame's own previous plane; (c) the plain VIF, ADM and motion
    entries over 2, 4 and 8 strips of card 0 of the 8K B=2 luma against
    unsharded (phase 12's bars); (d) the times."""
    from turbo_metrics_tpu_torch.parallel.mesh import make_mesh

    t0 = time.monotonic()
    card0 = f"cuda:{dev.index or 0}"
    errs = check_plain_vmaf(dev, card)
    prev_ms = check_motion_prev(dev, card)
    pair, motion_cases = wide_vmaf_inputs(dev)
    runs = run_strip_entries(plain_vmaf_strip_entries(pair, motion_cases[:1]), plain_vmaf_plan,
                             lambda what, entry, got, want: check_vmaf_outputs(what, entry.split(",")[0], got, want),
                             describe_vmaf, lambda n: make_mesh(n, device=card0), card, f"strips of {card0}",
                             WIDTH_STRIPS, False, "(14c)")
    del pair, motion_cases
    times = time_plain_vmaf(dev, card)
    log(f"phase 14: {time.monotonic() - t0:.1f} s [{card}]")
    return {"errs": errs, "prev_ms": prev_ms, "runs": runs, "times": times}


# Phase 15: scale 0 straight from packed integer sRGB.  (h, w, B, depth);
# 16-bit and 10-bit codes are uint16.
SRGB_CASES = ((HEIGHT, WIDTH, BATCH, 8), (HEIGHT, WIDTH, BATCH, 16), (HEIGHT + 1, WIDTH - 1, BATCH, 8),
              (HEIGHT, WIDTH, 1, 8), (67, 99, 3, 10))


def srgb_codes(dev, bsz: int, h: int, w: int, depth: int, seed: int):
    """Seeded (reference, distorted) (B, h, w, 3) codes on the card: uniform
    reference codes, the distorted ones up to 9 steps of 8-bit size off."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    hi = (1 << depth) - 1
    ref = torch.randint(0, hi + 1, (bsz, h, w, 3), generator=gen, device=dev, dtype=torch.int32)
    step = max(hi // 255, 1)
    dis = (ref + step * torch.randint(-9, 10, ref.shape, generator=gen, device=dev, dtype=torch.int32)).clamp(0, hi)
    dt = torch.uint8 if depth == 8 else torch.uint16
    return ref.to(dt), dis.to(dt)


def check_srgb_route(dev, card: str) -> dict:
    """Phase 15 (a), (b): the sRGB conversion pass against the plain route,
    bit for bit, and the engine's choice of it.  Returns fused_scale_srgb's
    launches over (a) and (b) and the largest difference measured."""
    from turbo_metrics_tpu_torch.engine import Metrics, TurboMetrics
    from turbo_metrics_tpu_torch.io.frame_source import RawFrame
    from turbo_metrics_tpu_torch.io.opencv_source import SRGB_CHARACTERISTICS
    from turbo_metrics_tpu_torch.models.ssimulacra2 import Ssimulacra2, ssimulacra2_subscores_from_rgb
    from turbo_metrics_tpu_torch.ops import colorspace
    from turbo_metrics_tpu_torch.ops.kernels import scale_stats

    total, err = 0, 0.0
    for k, (h, w, bsz, depth) in enumerate(SRGB_CASES):
        what = f"(15a) {w}x{h} B={bsz} {depth}-bit"
        ref, dis = srgb_codes(dev, bsz, h, w, depth, 1500 + k)
        model = Ssimulacra2(w, h, device=dev)
        reset_counts()
        got = model.subscores_from_srgb(ref, dis, depth=depth)
        table = model.code_table(ref.dtype, depth)
        sums, lvl1 = scale_stats.fused_scale_srgb(ref, dis, model.taps, model.opsin, table, depth=depth)
        launches = read_counts()
        need(launches["fused_scale_srgb"] == 2 and launches["fused_scale_rgb"] == 0,
             f"{what}: want two launches of fused_scale_srgb and none of #3, got {launches}")
        total += launches["fused_scale_srgb"]
        p12 = colorspace.srgb_pair_to_linear(ref, dis, depth=depth)
        want = ssimulacra2_subscores_from_rgb(p12, model.taps, model.opsin, num_scales=model.num_scales)
        sums_p, lvl1_p = scale_stats.fused_scale_rgb(p12, model.taps, model.opsin)
        for name, a, b in (("sub-scores", got, want), ("level-0 sums", sums, sums_p), ("level 1", lvl1, lvl1_p)):
            diff = float((a - b).abs().max())
            err = max(err, diff)
            if not torch.equal(a, b):
                need(False, f"{what}: {name} differ from the plain route's in {int((a != b).sum())} of "
                            f"{a.numel()}, by at most {diff:.3g}")
        log(f"{what}: sub-scores, sums and level 1 bit-equal to the plain route; launches "
            f"{ {n: v for n, v in launches.items() if v} } [{card}]")
        del ref, dis, p12, lvl1, lvl1_p
    # (b) the engine on host frames: the fused route against the pair buffer.
    h, w, n = 67, 99, 4
    ref, dis = (t.cpu().numpy() for t in srgb_codes(dev, n, h, w, 8, 1599))
    cc = SRGB_CHARACTERISTICS, "full"
    frames = [[RawFrame(rgb=f, depth=8) for f in x] for x in (ref, dis)]
    runs = {}
    for label, metrics in (("alone", Metrics(ssimulacra2=True)), ("with psnr", Metrics(ssimulacra2=True, psnr=True))):
        engine = TurboMetrics(w, h, metrics, batch=2, device=dev)
        reset_counts()
        runs[label] = [s.ssimulacra2 for b in (0, 2) for s in engine.compute_frames(
            frames[0][b:b + 2], cc, frames[1][b:b + 2], cc)]
        runs[label + " launches"] = read_counts()
    la, lp = runs["alone launches"], runs["with psnr launches"]
    need(la["fused_scale_srgb"] == 2 and la["fused_scale_rgb"] == 0 and lp["fused_scale_srgb"] == 0
         and lp["fused_scale_rgb"] == 2, f"(15b) engine routes: alone {la}, with psnr {lp}")
    need(runs["alone"] == runs["with psnr"], f"(15b) engine scores differ: {runs['alone']} vs {runs['with psnr']}")
    log(f"(15b) engine {w}x{h}, 8-bit RGB, two batches of 2: SSIMULACRA2 alone on fused_scale_srgb, with PSNR "
        f"on #3, scores bit-equal {runs['alone']} [{card}]")
    total += la["fused_scale_srgb"]
    err = max([err] + [abs(a - b) for a, b in zip(runs["alone"], runs["with psnr"])])
    return {"launches": total, "max_abs_err": err}


def time_srgb_route(dev, card: str) -> dict:
    """Phase 15 (c): times at 1080p B=8, u8 and 16-bit."""
    from turbo_metrics_tpu_torch.models.ssimulacra2 import Ssimulacra2, ssimulacra2_subscores_from_rgb
    from turbo_metrics_tpu_torch.ops import colorspace
    from turbo_metrics_tpu_torch.ops.kernels import scale_stats
    from turbo_metrics_tpu_torch.tools.kernel_dissect import time_ms

    model = Ssimulacra2(WIDTH, HEIGHT, device=dev)
    taps, opsin = model.taps, model.opsin
    level = ("level_tile_kernel", "reduce_parts_kernel")
    level1_bytes = 2 * BATCH * 3 * ((HEIGHT + 1) // 2) * ((WIDTH + 1) // 2) * 4
    out = {}
    for depth in (8, 16):
        ref, dis = srgb_codes(dev, BATCH, HEIGHT, WIDTH, depth, 1700 + depth)
        table = model.code_table(ref.dtype, depth)

        def fused(ref=ref, dis=dis, table=table, depth=depth):
            return scale_stats.fused_scale_srgb(ref, dis, taps, opsin, table, depth=depth)

        def plain(ref=ref, dis=dis, depth=depth):
            return scale_stats.fused_scale_rgb(colorspace.srgb_pair_to_linear(ref, dis, depth=depth), taps, opsin)

        def step_fused(ref=ref, dis=dis, depth=depth):
            return model.subscores_from_srgb(ref, dis, depth=depth)

        def step_plain(ref=ref, dis=dis, depth=depth):
            return ssimulacra2_subscores_from_rgb(colorspace.srgb_pair_to_linear(ref, dis, depth=depth), taps,
                                                  opsin, num_scales=model.num_scales)

        # In turns: fused, plain, plain, fused.
        ms = {"fused": [time_ms(fused, 20)], "plain": [time_ms(plain, 20), time_ms(plain, 20)]}
        ms["fused"].append(time_ms(fused, 20))
        step = {"fused": [time_ms(step_fused, 20)], "plain": [time_ms(step_plain, 20), time_ms(step_plain, 20)]}
        step["fused"].append(time_ms(step_fused, 20))
        r = {
            "ms": float(np.median(ms["fused"])), "plain_ms": float(np.median(ms["plain"])),
            "device_ms": device_ms(fused), "conversion_device_ms": device_ms(fused, ("srgb_to_xyb_kernel",)),
            "plain_device_ms": device_ms(plain),
            "plain_conversion_device_ms": device_ms(plain) - device_ms(plain, level),
            "step_ms": step["fused"], "step_plain_ms": step["plain"],
            "step_mib": step_peak_mib(step_fused, dev), "step_plain_mib": step_peak_mib(step_plain, dev),
            # The wrapper: codes in, level 1 and the sums out (as kernel 1's
            # row); its conversion pass: codes in, XYB and level 1 out.
            "nbytes": nbytes(ref, dis) + level1_bytes + BATCH * 3 * 6 * 4,
            "conversion_nbytes": nbytes(ref, dis) + 2 * BATCH * 3 * HEIGHT * WIDTH * 4 + level1_bytes,
        }
        log(f"(15c) 1080p B={BATCH} {depth}-bit: fused_scale_srgb {' / '.join(f'{t:.3f}' for t in ms['fused'])} ms "
            f"(device {r['device_ms']:.4f}, its conversion pass {r['conversion_device_ms']:.4f}) against the plain "
            f"route {' / '.join(f'{t:.3f}' for t in ms['plain'])} ms (device {r['plain_device_ms']:.4f}, its "
            f"conversion {r['plain_conversion_device_ms']:.4f}); the SSIMULACRA2 step "
            f"{' / '.join(f'{t:.3f}' for t in step['fused'])} ms against "
            f"{' / '.join(f'{t:.3f}' for t in step['plain'])} ms, peak above its inputs {r['step_mib']:.1f} MiB "
            f"against {r['step_plain_mib']:.1f} MiB [{card}]")
        out[depth] = r
        del ref, dis
    return out


def run_srgb_phase(dev, card: str) -> dict:
    """Phase 15: (a), (b) the sRGB conversion pass against the plain route
    and the engine's route; (c) the times.  Returns (c)'s figures by depth,
    and (a) and (b)'s launches and largest difference."""
    t0 = time.monotonic()
    checks = check_srgb_route(dev, card)
    times = time_srgb_route(dev, card)
    log(f"phase 15: {time.monotonic() - t0:.1f} s [{card}]")
    return {**times, **checks}


def main() -> int:
    try:
        from turbo_metrics_tpu_torch.models.ssimulacra2 import (
            Ssimulacra2,
            ssimulacra2_subscores_from_yuv,
        )
        from turbo_metrics_tpu_torch.ops import quality
        from turbo_metrics_tpu_torch.ops.kernels import (
            _build,
            adm,
            blur_probe,
            convert,
            downscale,
            fused_tail,
            integer_adm,
            integer_vif,
            motion,
            scale_stats,
            scale_tail,
            vif,
            windowed,
            windowed_tail,
            xpsnr,
        )
        from turbo_metrics_tpu_torch.ops.quality import Quality
        from turbo_metrics_tpu_torch.tools.kernel_dissect import time_ms
    except ImportError as e:
        log(f"chip_smoke: cannot import the port ({e}); run it from the repository root")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU")
        return 2

    # Phase 1: the card.
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = [f"nvidia-smi failed: {e}"]
    card = smi[0] if smi else "nvidia-smi printed nothing"
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # Phase 2: build.
    t0 = time.monotonic()
    _build.LIBRARY.get()
    log(f"kernels built and loaded in {time.monotonic() - t0:.2f} s "
        f"(nvcc {_build.LIBRARY.build_seconds:.2f} s) [{card}]")
    for ln in _build.LIBRARY.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            log(f"  ptxas: {ln.strip()}")
    check_level_blocks(_build.LIBRARY.get(), card)
    conv_sass = conversion_sass(card)
    integer_sass(card)
    probe_sass(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    with tempfile.TemporaryDirectory(prefix="tm_smoke_") as tmp:
        t0 = time.monotonic()
        ref_path, dis_path = write_y4m_pair(tmp)
        log(f"wrote {FRAMES}-frame {WIDTH}x{HEIGHT} Y4M pair in {time.monotonic() - t0:.1f} s")
        cli_scores, launches = run_main_path(ref_path, dis_path, dev, card)
        multi_scores, multi_launches = run_multi_path(ref_path, dis_path, dev, card, cli_scores)
        xpsnr_scores, xpsnr_launches = run_xpsnr_paths(ref_path, dis_path, dev, card, multi_scores)
        t0 = time.monotonic()
        mref_path, mdis_path = write_mezzanine_pair(tmp)
        log(f"wrote {FRAMES}-frame {WIDTH}x{HEIGHT} 4:2:2 10-bit / 4:2:0 8-bit Y4M pair in "
            f"{time.monotonic() - t0:.1f} s")
        mezz_scores, mezz_launches = run_mezzanine_path(mref_path, mdis_path, dev, card)
        vmaf_scores, _, vmaf_launches, vmaf_model = run_vmaf_paths(ref_path, dis_path, dev, card, tmp)
        int_scores, int_launches = run_vmaf_int_path(ref_path, dis_path, dev, card, vmaf_model, vmaf_scores)
        all6_scores, _ = run_all6_path(mref_path, mdis_path, dev, card, mezz_scores)
        run_mezz_int_path(mref_path, mdis_path, dev, card, all6_scores)
        t0 = time.monotonic()
        uref_path, udis_path = write_y4m_pair(tmp, UHD_WIDTH, UHD_HEIGHT, UHD_FRAMES, "_uhd")
        log(f"wrote {UHD_FRAMES}-frame {UHD_WIDTH}x{UHD_HEIGHT} Y4M pair in {time.monotonic() - t0:.1f} s")
        uhd_scores, uhd_launches = run_uhd_path(uref_path, udis_path, dev, card)
        clip_runs = run_compressed_path(dev, card, tmp, (ref_path, dis_path))
        y16 = load_pair(ref_path, dis_path, dev, FRAMES)[0]
        y2, uv2 = load_pair(ref_path, dis_path, dev)
        y422, uv422 = load_frames(mref_path, dev)
        y4k, uv4k = load_pair(uref_path, udis_path, dev, UHD_BATCH)
        # Phase 7, CLI part: each route again, warm, three times in turn
        # (host-clock times spread widely on a shared host).
        warm_runs = {
            "-m ssimulacra2": (ref_path, dis_path, ["ssimulacra2"], FRAMES, ()),
            "multi-metric": (ref_path, dis_path, MULTI, FRAMES, ()),
            "(a) -m xpsnr": (ref_path, dis_path, ["xpsnr"], FRAMES, ()),
            "(c) 4:2:2 10-bit vs 4:2:0, all five": (mref_path, mdis_path, ALL5, FRAMES, ()),
            "(d) -m vmaf": (ref_path, dis_path, ["vmaf"], FRAMES, ()),
            "(d-int) -m vmaf --vmaf-integer": (ref_path, dis_path, ["vmaf"], FRAMES, ("--vmaf-integer",)),
            "(e) 4:2:2 10-bit vs 4:2:0, all six": (mref_path, mdis_path, ALL6, FRAMES, ()),
            f"(f) {UHD_WIDTH}x{UHD_HEIGHT} -m ssimulacra2, {UHD_FRAMES} frames":
                (uref_path, udis_path, ["ssimulacra2"], UHD_FRAMES, ()),
        }
        warm_runs.update(clip_runs)
        warm_s = {k: [] for k in warm_runs}
        for _ in range(3):
            for k, (r, d, ms, n, extra) in warm_runs.items():
                warm_s[k].append(run_cli(r, d, dev, ms, extra=extra, frames=n)[2])

    model = Ssimulacra2(WIDTH, HEIGHT, device=dev)
    qmod = Quality(device=dev)
    taps, opsin, ns, win = model.taps, model.opsin, model.num_scales, qmod.window
    with torch.no_grad():
        e1, e2, lvl1 = check_parity(y2, uv2, model, cli_scores)
        check_other_formats(model)
        multi_err, p12, ms_l1 = check_multi_parity(y2, uv2, model, qmod, multi_scores)
        check_ssim_edges(dev, win)
        check_mixed_spec(dev)
        e13 = check_xpsnr_kernel(y16, xpsnr_scores)
        e5 = check_convert_kernel(y422, uv422)
        vmaf_err, vpair, vlevel1 = check_vmaf_kernels(y16, vmaf_scores)
        int_err, ipair = check_integer_kernels(y16, int_scores)
        check_integer_engine(dev)
        check_vif_edges(dev)
        check_adm_convert_edges(dev)
        check_motion_tail_edges(dev, taps, opsin)
        check_xpsnr_convert_edges(dev)
        check_mezzanine_engine(dev)
        model4k = Ssimulacra2(UHD_WIDTH, UHD_HEIGHT, device=dev)
        e4, lvl3 = check_uhd(y4k, uv4k, model4k, uhd_scores, dev)
        backend_launches, legacy_err, lin, xyb = check_backends(y2, uv2, model, dev)
        lin1 = probe_input(dev)
        e19 = check_blur_probe(lin1, taps)
        check_golden(dev)

        # Phase 7: timing (device time by CUDA events, after warm-up).
        def kernel_step():
            return ssimulacra2_subscores_from_yuv(y2, uv2, taps, opsin, num_scales=ns)

        def plain_step():
            _, l1 = scale_stats.fused_scale0_yuv_ref(y2, uv2, taps, opsin)
            return scale_tail.fused_pyramid_tail_ref(l1, ns - 1, taps, opsin)

        k1_ms = time_ms(lambda: scale_stats.fused_scale0_yuv(y2, uv2, taps, opsin), 20)
        k1_plain_ms = time_ms(lambda: scale_stats.fused_scale0_yuv_ref(y2, uv2, taps, opsin), 5)
        k2_ms = time_ms(lambda: scale_tail.fused_pyramid_tail(lvl1, ns - 1, taps, opsin), 20)
        k2_plain_ms = time_ms(lambda: scale_tail.fused_pyramid_tail_ref(lvl1, ns - 1, taps, opsin), 5)
        # Kernel, plain, plain, kernel: the spread within this run.
        step_ms = [time_ms(kernel_step, 20)]
        plain_ms = [time_ms(plain_step, 5), time_ms(plain_step, 5)]
        step_ms.append(time_ms(kernel_step, 20))
        step_mib = step_peak_mib(kernel_step, dev)

        lv, _ = quality._clamp_levels(HEIGHT, WIDTH, MS_LEVELS)
        k6_ms = time_ms(lambda: convert.yuv420_to_linear_rgb_pair(y2, uv2), 20)
        k6_plain_ms = time_ms(lambda: convert.yuv420_to_linear_rgb_pair_ref(y2, uv2), 5)
        k3_ms = time_ms(lambda: scale_stats.fused_scale_rgb(p12, taps, opsin), 20)
        k3_plain_ms = time_ms(lambda: scale_stats.fused_scale_rgb_ref(p12, taps, opsin), 5)
        k11_ms = time_ms(lambda: windowed.ssim_sums(p12, win, quantize=True, emit_ds=True), 20)
        k11_plain_ms = time_ms(lambda: windowed.ssim_sums_ref(p12, win, quantize=True, emit_ds=True), 5)
        k12_ms = time_ms(lambda: windowed_tail.msssim_tail(ms_l1, lv - 1, win), 20)
        k12_plain_ms = time_ms(lambda: windowed_tail.msssim_tail_ref(ms_l1, lv - 1, win), 5)
        psnr_ms = time_ms(lambda: qmod.from_rgb(p12, psnr=True), 20)
        multi_ms = [time_ms(lambda: multi_step_kernel(y2, uv2, model, qmod), 10)]
        multi_plain_ms = [time_ms(lambda: multi_step_plain(y2, uv2, model), 3) for _ in range(2)]
        multi_ms.append(time_ms(lambda: multi_step_kernel(y2, uv2, model, qmod), 10))
        multi_mib = step_peak_mib(lambda: multi_step_kernel(y2, uv2, model, qmod), dev)
        xp_args = (y16[0, :BATCH], y16[1, :BATCH], y16[0, 0])
        k13_ms = time_ms(lambda: xpsnr.xpsnr_block_stats(*xp_args), 20)
        k13_plain_ms = time_ms(lambda: xpsnr.xpsnr_block_stats_ref(*xp_args), 5)
        k5_kw = dict(depth=10, chroma=422)
        k5_ms = time_ms(lambda: convert.yuv_to_linear_rgb(y422, uv422, **k5_kw), 20)
        k5_plain_ms = time_ms(lambda: convert.yuv_to_linear_rgb_ref(y422, uv422, **k5_kw), 5)
        vy, vd = y16[0, :BATCH], y16[1, :BATCH]
        prev0 = motion.integer_blur(vy[:1])[0]
        k16_ms = time_ms(lambda: motion.motion_stats(vy, prev0), 20)
        k16_plain_ms = time_ms(lambda: motion.motion_stats_ref(vy, prev0), 3)
        k17_ms = time_ms(lambda: motion.integer_blur(vy[:1]), 20)
        k17_plain_ms = time_ms(lambda: motion.integer_blur_ref(vy[:1]), 3)
        k14_ms = time_ms(lambda: vif.vif_scale0(vpair), 20)
        k14_plain_ms = time_ms(lambda: vif.vif_scale0_ref(vpair), 3)
        k15_ms = time_ms(lambda: vif.vif_tail(vlevel1), 20)
        k15_plain_ms = time_ms(lambda: vif.vif_tail_ref(vlevel1), 3)
        k18_ms = time_ms(lambda: adm.adm_stats(vpair), 20)
        k18_plain_ms = time_ms(lambda: adm.adm_stats_ref(vpair), 3)
        vmaf_ms = [time_ms(lambda: vmaf_step(vy, vd, prev0, True), 10)]
        vmaf_plain_ms = [time_ms(lambda: vmaf_step(vy, vd, prev0, False), 3) for _ in range(2)]
        vmaf_ms.append(time_ms(lambda: vmaf_step(vy, vd, prev0, True), 10))
        vmaf_mib = step_peak_mib(lambda: vmaf_step(vy, vd, prev0, True), dev)
        kiv_ms = time_ms(lambda: integer_vif.integer_vif_stats(ipair), 20)
        kiv_plain_ms = time_ms(lambda: integer_vif.integer_vif_stats_ref(ipair), 3)
        kia_ms = time_ms(lambda: integer_adm.integer_adm_stats(ipair), 20)
        kia_plain_ms = time_ms(lambda: integer_adm.integer_adm_stats_ref(ipair), 3)
        kiv_dev_ms = device_ms(lambda: integer_vif.integer_vif_stats(ipair),
                               ("integer_vif_kernel", "reduce_frames_kernel"))
        kia_dev_ms = device_ms(lambda: integer_adm.integer_adm_stats(ipair),
                               ("integer_adm_kernel", "reduce_frames_kernel"))
        # The integer VMAF step beside the float one: float, integer, integer
        # plain, integer plain, integer, float.
        vmaf_f_ms = [time_ms(lambda: vmaf_step(vy, vd, prev0, True), 10)]
        vmaf_int_ms = [time_ms(lambda: vmaf_int_step(vy, vd, prev0, True), 10)]
        vmaf_int_plain_ms = [time_ms(lambda: vmaf_int_step(vy, vd, prev0, False), 3) for _ in range(2)]
        vmaf_int_ms.append(time_ms(lambda: vmaf_int_step(vy, vd, prev0, True), 10))
        vmaf_f_ms.append(time_ms(lambda: vmaf_step(vy, vd, prev0, True), 10))
        vmaf_int_mib = step_peak_mib(lambda: vmaf_int_step(vy, vd, prev0, True), dev)
        k4_ms = time_ms(lambda: fused_tail.fused_tail(lvl3, 3, taps, opsin), 20)
        k4_plain_ms = time_ms(lambda: fused_tail.fused_tail_ref(lvl3, 3, taps, opsin), 5)
        k2_lvl3_ms = time_ms(lambda: scale_tail.fused_pyramid_tail(lvl3, 3, taps, opsin), 20)
        # The chain's 4K step and the route it replaced, on the same inputs:
        # chain, kernel 2, plain, plain, kernel 2, chain.
        uhd_ms = [time_ms(lambda: uhd_step_kernel(y4k, uv4k, model4k), 10)]
        uhd_k2_ms = [time_ms(lambda: uhd_step_kernel2(y4k, uv4k, model4k), 10)]
        uhd_plain_ms = [time_ms(lambda: uhd_step_plain(y4k, uv4k, model4k), 3) for _ in range(2)]
        uhd_k2_ms.append(time_ms(lambda: uhd_step_kernel2(y4k, uv4k, model4k), 10))
        uhd_ms.append(time_ms(lambda: uhd_step_kernel(y4k, uv4k, model4k), 10))
        uhd_dev_ms = device_ms(lambda: uhd_step_kernel(y4k, uv4k, model4k), iters=10)
        uhd_mib = step_peak_mib(lambda: uhd_step_kernel(y4k, uv4k, model4k), dev)
        uhd_k2_dev_ms = device_ms(lambda: uhd_step_kernel2(y4k, uv4k, model4k), iters=10)
        k7_ms = time_ms(lambda: downscale.downscale_by_2(lin[0]), 20)
        k7_plain_ms = time_ms(lambda: downscale.downscale_by_2_ref(lin[0]), 5)
        k7_lib_ms = time_ms(lambda: torch.nn.functional.avg_pool2d(lin[0], 2, ceil_mode=True), 20)
        k8_ms = time_ms(lambda: scale_stats.scale_sums(*xyb, taps), 20)
        k8_plain_ms = time_ms(lambda: scale_stats.level_sums_ref(*xyb, taps), 5)
        k10_ms = time_ms(lambda: scale_stats.fused_scale_pair(lin[0], lin[1], taps, opsin), 20)
        k10_plain_ms = time_ms(lambda: scale_stats.fused_scale_pair_ref(lin[0], lin[1], taps, opsin), 5)
        k13_dev_ms = device_ms(lambda: xpsnr.xpsnr_block_stats(*xp_args), ("xpsnr_kernel",))
        k5_dev_ms = device_ms(
            lambda: convert.yuv_to_linear_rgb(y422, uv422, **k5_kw), ("yuv_to_rgb_kernel",))
        k6_dev_ms = device_ms(lambda: convert.yuv420_to_linear_rgb_pair(y2, uv2), ("yuv_to_rgb_kernel",))
        k1_conv_dev_ms = device_ms(lambda: scale_stats.fused_scale0_yuv(y2, uv2, taps, opsin),
                                   ("yuv420_to_xyb_kernel",))
        k1_dev_ms = device_ms(lambda: scale_stats.fused_scale0_yuv(y2, uv2, taps, opsin))
        k4_dev_ms = device_ms(lambda: fused_tail.fused_tail(lvl3, 3, taps, opsin), ("fused_tail_kernel",))
        k2_lvl3_dev_ms = device_ms(
            lambda: scale_tail.fused_pyramid_tail(lvl3, 3, taps, opsin),
            ("rgb_to_xyb_kernel", "level_tile_kernel", "reduce_parts_kernel"))
        # #16's device time holds the memset that zeroes its row sums.
        k16_dev_ms = device_ms(lambda: motion.motion_stats(vy, prev0), ("memset", "motion_kernel"))
        k16_memset_ms = device_ms(lambda: motion.motion_stats(vy, prev0), ("memset",))
        k17_dev_ms = device_ms(lambda: motion.integer_blur(vy[:1]), ("motion_kernel",))
        # Which 4K levels #4 and kernel 2 should take: each on levels s..5
        # from each first level s (kernel 1's emitted level 1, then 2x2 means).
        uhd_levels, lvl = [], scale_stats.fused_scale0_yuv(y4k, uv4k, taps, opsin)[1]
        for first in range(1, model4k.num_scales):
            n = model4k.num_scales - first
            k4_call = lambda: fused_tail.fused_tail(lvl, n, taps, opsin)  # noqa: E731
            k2_call = lambda: scale_tail.fused_pyramid_tail(lvl, n, taps, opsin)  # noqa: E731
            uhd_levels.append((first, tuple(lvl.shape[-2:]), device_ms(k4_call, ("fused_tail_kernel",)),
                               device_ms(k2_call, ("rgb_to_xyb_kernel", "level_tile_kernel",
                                                   "reduce_parts_kernel")),
                               time_ms(k4_call, 20), time_ms(k2_call, 20)))
            lvl = plain_level(lvl, 1)
        del lvl
        # #19 on the dissect tool's input; its yardsticks, five F.conv2d
        # blurs of the padded planes in full f32 (TF32 off for the call),
        # separable (the row's library_ms) and as one 11x11 kernel, are timed
        # here only.
        k19_ms = time_ms(lambda: blur_probe.blur_only(lin1, taps), 20)
        k19_one_ms = time_ms(lambda: blur_probe.blur_only(lin1, taps, passes=1), 20)
        k19_plain_ms = time_ms(lambda: blur_probe.blur_only_ref(lin1, taps), 5)
        rh, rw = blur_probe.region(HEIGHT, WIDTH)
        xp = torch.nn.functional.pad(lin1.reshape(-1, 1, HEIGHT, WIDTH), (0, rw - WIDTH, 0, rh - HEIGHT))
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            k19_lib_ms = time_ms(lambda: conv_blur_sums(xp, taps, True), 5)
            k19_dense_ms = time_ms(lambda: conv_blur_sums(xp, taps, False), 5)
            conv_sums = [conv_blur_sums(xp, taps, sep).reshape(-1) for sep in (True, False)]
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        probe_sums = blur_probe.blur_only(lin1, taps)[:, 0, 0]
        # Whether the repetitions all ran, by the probe kernel's device time:
        # a call of passes=1 is short enough for the host's launch gaps to
        # set its CUDA-event time (0.112 against 0.065 ms once).
        k19_dev = [device_ms(lambda p=p: blur_probe.blur_only(lin1, taps, passes=p), ("blur_probe_kernel",))
                   for p in (5, 1)]
        need(k19_dev[0] >= 2 * k19_dev[1], f"#19 passes=5 {k19_dev[0]:.4f} ms vs passes=1 {k19_dev[1]:.4f} ms "
             "of device time: the repetitions were not all run")
        del xp
        dissect, dissect_launches = run_dissect_path(card)
        run_mesh_phase(dev, card)
        width = run_width_phase(dev, Ssimulacra2(WIDE_WIDTH, WIDE_HEIGHT, device=dev), card)
        metric_width = run_metric_width_phase(dev, qmod, card)
        vmaf_width = run_vmaf_width_phase(dev, card)
        int_plain = run_int_plain_phase(dev, card)
        plain_vmaf = run_plain_vmaf_phase(dev, card)
        srgb = run_srgb_phase(dev, card)

    mpx = WIDTH * HEIGHT / 1e6
    for name, runs in (
        ("kernel step", step_ms), ("plain step", plain_ms),
        ("multi-metric kernel step", multi_ms), ("multi-metric plain step", multi_plain_ms),
        ("VMAF kernel step", vmaf_ms), ("VMAF plain step", vmaf_plain_ms),
        ("VMAF kernel step, float features (beside the integer step)", vmaf_f_ms),
        ("VMAF kernel step, vmaf_integer", vmaf_int_ms), ("VMAF plain step, vmaf_integer", vmaf_int_plain_ms),
    ):
        log(
            f"{name} B={BATCH} {WIDTH}x{HEIGHT}: "
            + " / ".join(f"{t:.3f} ms = {BATCH * 1e3 / t:.1f} fps = {BATCH * mpx * 1e3 / t:.1f} Mpx/s" for t in runs)
            + f" [{card}]"
        )
    umpx = UHD_WIDTH * UHD_HEIGHT / 1e6
    for name, runs in (("4K kernel step", uhd_ms), ("4K plain step", uhd_plain_ms),
                       ("4K step by kernel 1 + kernel 2 (the route before the level chain)", uhd_k2_ms)):
        log(
            f"{name} B={UHD_BATCH} {UHD_WIDTH}x{UHD_HEIGHT}: "
            + " / ".join(f"{t:.3f} ms = {UHD_BATCH * 1e3 / t:.1f} fps = {UHD_BATCH * umpx * 1e3 / t:.1f} Mpx/s"
                         for t in runs)
            + f" [{card}]"
        )
    log(f"peak device memory of one kernel step above its inputs: SSIMULACRA2 {WIDTH}x{HEIGHT} B={BATCH} "
        f"{step_mib:.1f} MiB, multi-metric {multi_mib:.1f} MiB, VMAF {vmaf_mib:.1f} MiB, VMAF vmaf_integer "
        f"{vmaf_int_mib:.1f} MiB, SSIMULACRA2 "
        f"{UHD_WIDTH}x{UHD_HEIGHT} B={UHD_BATCH} {uhd_mib:.1f} MiB [{card}]")
    log(f"kernel 2 on the same 4K level-3 plane as #4: {k2_lvl3_ms:.3f} ms (#4 {k4_ms:.3f} ms) [{card}]")
    log(f"avg_pool2d(2, ceil_mode=True) on #7's input: {k7_lib_ms:.3f} ms (#7 {k7_ms:.3f} ms) [{card}]")
    rel = [float(((c - probe_sums) / probe_sums).abs().max()) for c in conv_sums]
    log(f"#19 passes=1 {k19_one_ms:.4f} ms, passes=5 {k19_ms:.4f} ms (ratio {k19_ms / k19_one_ms:.2f}; its "
        f"kernel's device time {k19_dev[1]:.4f} / {k19_dev[0]:.4f} ms, ratio {k19_dev[0] / k19_dev[1]:.2f}); "
        f"five F.conv2d blurs (TF32 off): separable {k19_lib_ms:.3f} ms, one 11x11 kernel "
        f"{k19_dense_ms:.3f} ms, their sums vs #19's max rel diff {rel[0]:.3g} / {rel[1]:.3g} [{card}]")
    log(f"PSNR (plain torch expression on the pair buffer) {psnr_ms:.3f} ms [{card}]")
    for first, hw, d4, d2, c4, c2 in uhd_levels:
        log(f"4K B={UHD_BATCH} levels {first}-{model4k.num_scales - 1} from {hw[1]}x{hw[0]}: #4 device "
            f"{d4:.4f} ms (call {c4:.3f}), kernel 2 device {d2:.4f} ms (its kernels only; call {c2:.3f}) "
            f"[{card}]")
    log(f"kernel 1 B={BATCH}: its conversion pass yuv420_to_xyb_kernel {k1_conv_dev_ms:.4f} ms of "
        f"{k1_dev_ms:.4f} ms device time ({100 * k1_conv_dev_ms / k1_dev_ms:.1f}%) [{card}]")
    for name, t in (("xpsnr_block_stats", k13_dev_ms), ("yuv_to_linear_rgb", k5_dev_ms),
                    ("yuv420_to_linear_rgb_pair (B=8 pair)", k6_dev_ms),
                    (f"motion_stats (B=8 u8; its row sums' memset {k16_memset_ms:.4f} ms of it)", k16_dev_ms),
                    ("integer_blur (one u8 frame)", k17_dev_ms),
                    ("integer_vif_stats (B=8 u8, four scales)", kiv_dev_ms),
                    ("integer_adm_stats (B=8 u8, four levels)", kia_dev_ms),
                    ("fused_tail (4K level 3)", k4_dev_ms),
                    ("fused_pyramid_tail on the same plane (its 12 kernels)", k2_lvl3_dev_ms),
                    ("4K kernel step, every kernel (kernel 1, #3 x2, #4)", uhd_dev_ms),
                    ("4K step by kernel 1 + kernel 2, every kernel", uhd_k2_dev_ms)):
        log(f"{name}: kernel device time {t:.4f} ms "
            f"(torch.profiler, wrapper host time excluded) [{card}]")
    for k, runs in warm_s.items():
        log(f"CLI warm, {FRAMES} frames, {k}: " + " / ".join(f"{t * 1e3:.1f}" for t in runs)
            + f" ms, median {float(np.median(runs)) * 1e3:.1f} ms (host clock) [{card}]")
    if clip_runs:
        ck, yk = clip_runs
        log(f"CLI warm (g), -m ssimulacra2, {FRAMES} frames {WIDTH}x{HEIGHT}: the compressed pair "
            f"{float(np.median(warm_s[ck])) * 1e3:.1f} ms beside {yk} {float(np.median(warm_s[yk])) * 1e3:.1f} ms "
            f"(medians, host clock) [{card}]")

    # Bounds from this run's shapes: bytes each input read once and each
    # output written once, f32 operations of the algorithm (F_* above), or
    # int32 operations for XPSNR (I_XPSNR); for #5 and #6 the issue of their
    # SASS instructions and MUFU (CONVERSION_SASS) instead of f32 operations.
    _, bsz, h, w = y2.shape
    hq, wq = (h + 1) // 2, (w + 1) // 2
    conv_ms = {
        "yuv_to_linear_rgb": issue_ms(conv_sass["yuv_to_linear_rgb"], bsz * h * wq, dev),
        "yuv420_to_linear_rgb_pair": issue_ms(conv_sass["yuv420_to_linear_rgb_pair"], 2 * bsz * hq * wq, dev),
    }
    xp_out = bsz * 3 * 4 * -(-h // 16) * -(-w // 16)
    mh1, mw1 = ms_l1.shape[-2:]
    dims_s2 = model.dims
    s0_out = torch.empty(bsz, 3, 6)
    rows = [
        ("fused_scale0_yuv", "ssimulacra2_scale.cu", PALLAS + "scale_stats.py:1985", launches, e1, k1_ms,
         k1_plain_ms, nbytes(y2, uv2, lvl1, s0_out), bsz * h * w * 2 * F_CONVERT + s2_level_flops(bsz, h, w)),
        ("fused_pyramid_tail", "ssimulacra2_scale.cu", PALLAS + "scale_tail.py:243", launches, e2, k2_ms,
         k2_plain_ms, nbytes(lvl1) + (ns - 1) * nbytes(s0_out),
         sum(s2_level_flops(bsz, lh, lw) for lh, lw in dims_s2[1:])),
        ("fused_scale_rgb", "ssimulacra2_scale.cu", PALLAS + "scale_stats.py:2552", multi_launches,
         multi_err["fused_scale_rgb"], k3_ms, k3_plain_ms, nbytes(p12, lvl1, s0_out),
         s2_level_flops(bsz, h, w)),
        ("yuv420_to_linear_rgb_pair", "convert.cu", PALLAS + "convert.py:404", multi_launches,
         multi_err["yuv420_to_linear_rgb_pair"], k6_ms, k6_plain_ms, nbytes(y2, uv2, p12), 0),
        ("ssim_sums", "windowed.cu", PALLAS + "windowed.py:400", multi_launches, multi_err["ssim_sums"],
         k11_ms, k11_plain_ms, nbytes(p12, ms_l1) + bsz * 3 * 2 * 4,
         ssim_level_flops(bsz, h, w, True, True)),
        ("msssim_tail", "windowed.cu", PALLAS + "windowed_tail.py:376", multi_launches,
         multi_err["msssim_tail"], k12_ms, k12_plain_ms, nbytes(ms_l1) + bsz * (lv - 1) * 3 * 2 * 4,
         sum(ssim_level_flops(bsz, mh1 >> i, mw1 >> i, False, i + 2 < lv) for i in range(lv - 1))),
        ("yuv_to_linear_rgb", "convert.cu", PALLAS + "convert.py:125", mezz_launches, e5, k5_ms, k5_plain_ms,
         nbytes(y422, uv422) + bsz * 3 * h * w * 4, 0),
        ("xpsnr_block_stats", "xpsnr.cu", PALLAS + "xpsnr.py:197", xpsnr_launches, e13, k13_ms, k13_plain_ms,
         nbytes(*xp_args) + xp_out, bsz * h * w * I_XPSNR),
        ("vif_scale0", "vif.cu", PALLAS + "vif.py:540", vmaf_launches, vmaf_err["vif_scale0"], k14_ms,
         k14_plain_ms,
         nbytes(vpair, vlevel1) + bsz * 2 * 4, vif_flops(bsz, h, w, (0,))),
        ("vif_tail", "vif.cu", PALLAS + "vif_tail.py:331", vmaf_launches, vmaf_err["vif_tail"], k15_ms,
         k15_plain_ms,
         nbytes(vlevel1) + bsz * 3 * 2 * 4, vif_flops(bsz, h, w, (1, 2, 3))),
        ("motion_stats", "motion.cu", PALLAS + "motion.py:180", vmaf_launches, vmaf_err["motion_stats"], k16_ms,
         k16_plain_ms, nbytes(vy, prev0) + bsz * h * w * 2 + bsz * h * 8, bsz * h * w * I_MOTION),
        ("integer_blur", "motion.cu", PALLAS + "motion.py:236", vmaf_launches, vmaf_err["integer_blur"], k17_ms,
         k17_plain_ms, nbytes(vy[:1]) + h * w * 2, h * w * I_BLUR),
        ("adm_stats", "adm.cu", PALLAS + "adm.py:442", vmaf_launches, vmaf_err["adm_stats"], k18_ms,
         k18_plain_ms,
         nbytes(vpair) + bsz * 4 * 3 * 2 * 4, adm_flops(bsz, h, w)),
        ("fused_tail", "ssimulacra2_tail.cu", PALLAS + "scale_stats.py:2494", uhd_launches, e4, k4_ms,
         k4_plain_ms,
         nbytes(lvl3) + UHD_BATCH * 3 * 3 * 6 * 4,
         sum(s2_level_flops(UHD_BATCH, lh, lw) for lh, lw in model4k.dims[3:])),
        ("downscale_by_2", "downscale.cu", PALLAS + "convert.py:500", backend_launches["pallas2"],
         legacy_err["downscale_by_2"], k7_ms, k7_plain_ms, nbytes(lin[0]) + nbytes(lin[0]) // 4,
         bsz * 3 * (h // 2) * (w // 2) * 4, k7_lib_ms),
        ("scale_sums", "ssimulacra2_scale.cu", PALLAS + "scale_stats_legacy.py:172", backend_launches["pallas"],
         legacy_err["scale_sums"], k8_ms, k8_plain_ms, nbytes(*xyb) + nbytes(s0_out), bsz * h * w * 3 * F_S2),
        # #9 (v2) computes #10's function: one entry, measured once, two rows.
        ("fused_scale_pair", "ssimulacra2_scale.cu", PALLAS + "scale_stats_legacy.py:367",
         backend_launches["pallas2"],
         legacy_err["fused_scale_pair"], k10_ms, k10_plain_ms, nbytes(lin) + nbytes(s0_out),
         bsz * h * w * (2 * (F_XYB - 4) + 3 * F_S2)),
        ("fused_scale_pair", "ssimulacra2_scale.cu", PALLAS + "scale_stats_legacy.py:644",
         backend_launches["pallas2"],
         legacy_err["fused_scale_pair"], k10_ms, k10_plain_ms, nbytes(lin) + nbytes(s0_out),
         bsz * h * w * (2 * (F_XYB - 4) + 3 * F_S2)),
        ("blur_only", "blur_probe.cu", "tools/kernel_dissect.py:106", dissect_launches, e19, k19_ms,
         k19_plain_ms, nbytes(lin1) + lin1.shape[0] * 3 * 64 * 4, lin1.shape[0] * 3 * rh * rw * F_PROBE,
         k19_lib_ms),
    ]
    # Kernels with no TPU counterpart (the JAX package's jnp functions they
    # port), bound by int32 and f32 operations sharing the issue.
    iv_ops, ia_ops = integer_vif_ops(bsz, h, w), integer_adm_ops(bsz, h, w)
    int_rows = [
        ("integer_vif_stats", "integer_vif.cu", "turbo_metrics_tpu/ops/integer_vif.py:100", int_err, kiv_ms,
         kiv_plain_ms, nbytes(ipair) + bsz * 4 * 2 * 4, iv_ops, kiv_dev_ms),
        ("integer_adm_stats", "integer_adm.cu", "turbo_metrics_tpu/ops/integer_adm.py:107", int_err, kia_ms,
         kia_plain_ms, nbytes(ipair) + bsz * 4 * 3 * 2 * 4, ia_ops, kia_dev_ms),
    ]
    kernels = []
    for name, src_file, replaces, counts, err, ms, pms, nb, ops, *lib in rows:
        is_int = name in ("xpsnr_block_stats", "motion_stats", "integer_blur")
        bound_ms, bound_by = bound(nb, ops, PEAK_I32_PER_S if is_int else PEAK_F32_PER_S, conv_ms.get(name, 0.0))
        log(f"{name}: {ms:.3f} ms vs plain {pms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({nb / 1e6:.1f} MB, {ops / 1e9:.2f} G{'int32 ops' if is_int else 'FLOP'}), "
            f"launches {counts[name]}, max abs err {err:.3g} [{card}]")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": CSRC + src_file,
            "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": pms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # #7's function is one PyTorch call (avg_pool2d), #19's five
            # separable F.conv2d blurs, timed above as yardsticks; the port
            # never calls them.
            "library_ms": lib[0] if lib else None,
            # Kernels 1 and #3 were redesigned around the fused level pass,
            # #11, #14 and #18 around a fused tile pass (one tile kernel per
            # level instead of a row and a column pass and an emission or
            # mask pass), #4 around the same level pass, #16 and #17 around
            # a blur in registers, #5 and #6 around fewer instructions per
            # transfer function and wide accesses, #13 around 16-byte row
            # chunks in registers.
            "redesigned": REDESIGNED.get(name),
            "tpu_kernel": True,
        })
        if name in width["window_err"]:
            # Kernels 1, 2, #3 and #4 with a window of owned columns that
            # cuts tiles mid-way, against their twins (phase 10b).
            kernels[-1]["windowed_max_abs_err"] = width["window_err"][name]
        if name in metric_width["window_err"]:
            # #11 and #12 likewise (phase 11c).
            kernels[-1]["windowed_max_abs_err"] = metric_width["window_err"][name]
        if name in ("vif_scale0", "vif_tail", "adm_stats"):
            # #14, #15 and #18 likewise (phase 12b).
            kernels[-1]["windowed_max_abs_err"] = vmaf_width["window_err"][name]
        if name == "xpsnr_block_stats":
            # Phase 11 (b) and (d) stop the run where a strip's grids differ;
            # phase 13 (c) where the per-frame previous planes give other
            # grids than the plain route's.
            kernels[-1]["sharded_grids_equal"] = True
            kernels[-1]["per_frame_prev_equal"] = int_plain["plain"]["xpsnr_prev_equal"]
        if name in ("motion_stats", "integer_blur"):
            # Phase 12 (a) and (c) stop the run where a strip's blurred
            # planes or row SADs differ from the unsharded call's.
            kernels[-1]["sharded_planes_equal"] = True
        if name == "motion_stats":
            # Phase 14 (b) stops the run where #16 with every frame's own
            # previous plane differs from its twin or the plain route; its
            # time at 1080p u8 B=8 in turns with the prev0 convention's.
            kernels[-1]["per_frame_prev_ms"] = plain_vmaf["prev_ms"]["per-frame prev"]
            kernels[-1]["prev0_ms"] = plain_vmaf["prev_ms"]["prev0"]
    for name, src_file, ports, err, ms, pms, nb, (i_ops, f_ops), dms in int_rows:
        bound_ms, bound_by = bound(nb, 0.0, issue=mixed_ops_ms(i_ops, f_ops))
        unfolded = ""
        if name == "integer_vif_stats":
            unfolded = f"; with unfolded windows {mixed_ops_ms(*integer_vif_ops(bsz, h, w, folded=False)):.4f} ms"
        log(f"{name}: {ms:.3f} ms (device {dms:.4f}) vs plain {pms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({nb / 1e6:.1f} MB, {i_ops / 1e9:.2f} G int32 ops + {f_ops / 1e9:.2f} G FLOP{unfolded}), launches "
            f"{int_launches[name]}, max abs err {err[name]:.3g} [{card}]")
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + src_file,
            # No TPU kernel: the jnp function of the JAX package it ports.
            "replaces": ports, "launches": int_launches[name], "max_abs_err": err[name], "ms": ms,
            "plain_ms": pms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "redesigned": REDESIGNED.get(name), "tpu_kernel": False, "device_ms": dms,
            # With a window of owned columns that cuts tiles mid-way, against
            # the twin (phase 13b).
            "windowed_max_abs_err": int_plain["window_err"][name],
        })
    # The sRGB conversion pass, which replaces no TPU kernel (the JAX
    # package converts packed sRGB with jnp).  The row's bound is the whole
    # wrapper's, as kernel 1's: bytes (codes in, level 1 and sums out)
    # against the level's f32 work (the table lookups add none); the pass
    # alone (codes in, XYB and level 1 out, its XYB work) under its own keys.
    r = srgb[8]
    wrap_ms, wrap_by = bound(r["nbytes"], s2_level_flops(BATCH, HEIGHT, WIDTH))
    conv_ms, conv_by = bound(r["conversion_nbytes"], 2 * BATCH * HEIGHT * WIDTH * F_XYB)
    log(f"fused_scale_srgb: {r['ms']:.3f} ms (device {r['device_ms']:.4f}) vs plain {r['plain_ms']:.3f} ms, bound "
        f"{wrap_ms:.4f} ms by {wrap_by} ({r['nbytes'] / 1e6:.1f} MB); its conversion pass device "
        f"{r['conversion_device_ms']:.4f} ms (the plain conversion's {r['plain_conversion_device_ms']:.4f}), bound "
        f"{conv_ms:.4f} ms by {conv_by} ({r['conversion_nbytes'] / 1e6:.1f} MB); launches {srgb['launches']}, "
        f"max abs err {srgb['max_abs_err']:.3g} [{card}]")
    kernels.append({
        "name": "fused_scale_srgb", "route": "cuda", "source": CSRC + "ssimulacra2_scale.cu",
        # No TPU kernel: the JAX package converts packed sRGB with jnp.
        "replaces": "turbo_metrics_tpu/ops/colorspace.py srgb_to_linear (jnp)", "launches": srgb["launches"],
        "max_abs_err": srgb["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": wrap_ms,
        "bound_by": wrap_by, "library_ms": None, "redesigned": None, "tpu_kernel": False,
        "device_ms": r["device_ms"], "conversion_device_ms": r["conversion_device_ms"],
        "conversion_bound_ms": conv_ms, "conversion_bound_by": conv_by,
        "plain_conversion_device_ms": r["plain_conversion_device_ms"],
        "ms_16bit": srgb[16]["ms"], "plain_ms_16bit": srgb[16]["plain_ms"],
    })
    peak = max(RUN_PEAK[0], torch.cuda.max_memory_allocated(dev))
    log(f"peak device memory {peak / 2**30:.2f} GiB [{card}]")

    print(card)
    print(json.dumps(dissect))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        log(f"chip_smoke FAILED: {e}")
        sys.exit(1)
