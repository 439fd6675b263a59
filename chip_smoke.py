#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (flappie_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Card and build: the card's name and power limit, the torch/CUDA
   versions, then every CUDA kernel built from flappie_tpu_torch/csrc/
   with nvcc for sm_90a (one nvcc per source, all at once), the build
   seconds, ptxas's registers and spills of each kernel, the cluster
   recurrence's plan for each instantiation (rows a cluster, clusters,
   shared bytes, held to ops/rnn_cuda.py's _cluster_plan) with
   cudaOccupancyMaxActiveClusters, the batch-minor chain scans' plan
   (reads a warp, chain warps a CTA, CTAs, ring bytes; flappie_crf_scan_info
   held to ops/crf_bm_cuda.py's _scan_plan) and K11's forward and Viterbi
   scans' plan (the same and the ring's read stride; flappie_crf_bt_info
   held to ops/crf_cuda.py's _bt_plan), and the tracebacks' plan (K6 and
   K11's: steps a segment, rounds, clusters of CTAs, shared bytes;
   flappie_crf_traceback_info and flappie_crf_bt_traceback_info held to
   _tb_plan and _tb_bt_plan) with cudaOccupancyMaxActiveClusters, every
   cluster resident at T=2560, B=256 and T=13,108, B=24, and both
   affines' plans (path, tile, k step, stages, shared bytes, CTAs, tiles;
   flappie_affine_info held to ops/rnn_cuda.py's _affine_plan at the
   model shapes and the edges).  Beside the path's build, and at
   the same time, the other builds (VARIANTS): crf_scan.cu with
   -DSCAN_WARPS=1, 2, 4, crf_bt.cu with -DBT_WARPS=1, 2, 4, and conv12.cu
   with -DCONV12_PERSIST=0, -DCONV12_BULK=0 and -DCONV12_FAST_SWISH=0.
2. Kernels: each kernel held against its plain PyTorch version on the
   card at production shapes -- K1 fused LSTM layer, K8 its training
   variant (h and c; h bit-equal to K1's) and K7 fused GRU-mod layer
   (T=2560, B=256, IN=H=256, both directions, ragged lengths including 0
   and T, K7 with a candidate bias far from zero) within max |delta|
   1e-4, each timed over 10 runs alternated with its cuDNN call (medians,
   spread, kernel/cuDNN ratio); K1 also at runnie's heaviest program
   (T=13,108, B=24) and at the training shape (T=512, B=32), held to its
   plain version and timed beside cuDNN and the recurrence alone (K12),
   with the per-step time and the cluster plan; the batch-minor scans (T=2560, B=256, ragged nblocks, S=8 for
   4 bases and S=10 for 5): K3/K4 CRF sum scan within rtol 1e-5, K9 (K3
   and K4 in one launch) within rtol 1e-5 and bit-equal to K3/K4, K5
   Viterbi and K6 traceback bit-equal (K6 also to its segmented twin;
   the tracebacks, microseconds long, timed behind a device sleep so that
   the wrapper's host work is not), K3/K4, K9 and K5 timed over 10
   runs with their time a step and CTAs, and K3 at 1, 2 and 4 chain warps
   a CTA (crf_scan.cu built with -DSCAN_WARPS=n beside the path's build),
   each bit-equal to the path's K3, alternated; the batch-major K11 (T=2560,
   B=256, the run-length structure at S=8 and the flip-flop at S=8 and
   S=10): forward scan within rtol 1e-5, Viterbi (alphas, int8
   backpointers) and traceback bit-equal, the forward and Viterbi scans
   timed over 10 runs with their time a step, CTAs and registers, and in
   K11's other builds (1, 2, 4 chain warps a CTA), each bit-equal to the
   path's, alternated, the forward scan over the
   backward pass's transposed, time-reversed view profiled (the copy that
   makes it contiguous beside the kernel); and K3/K4, K9, K5, K6 and K11
   with the run-length structure at the shape of runnie's heaviest program
   (T=13,108 blocks, B=24), by the same rules, K3, K9, K5, K6 and K11's
   three timed there too (with K3's and K11's other builds), and both
   tracebacks at one step (their floor); K10, the fused conv
   1->4->16 (B=256, T=12800 samples; B=24, T=65,536; B=32, T=2560; ragged
   lengths including 0, 3 and T, then every read full) within 1e-5
   absolute and zero past every length, with its plan (held to
   _conv12_plan), registers and bound fraction, timed behind a device
   sleep, and its other builds at B=256, T=12800, each bit-equal to the
   path's, alternated; K12, the recurrences alone over a computed
   affine (T=2560, B=256, H=256), LSTM and GRU-mod within 1e-4 of
   ops/rnn.py's lstm_seq / grumod_seq.  Times are CUDA-event medians
   after a warm-up; the bound is the larger of bytes over the card's
   memory rate and f32 operations over its non-tensor f32 rate, counted
   for this run's inputs; the library time is one cuDNN nn.LSTM / nn.GRU
   call on the packed ragged batch (for K8 its training-mode forward);
   for K10 two cuDNN F.conv1d calls with swish and the masks between
   them; for K12 one nn.LSTM / nn.GRU with weight_ih the identity.
   The f32 affine alone (csrc/affine.cuh affine_kernel, the one inside
   K1, K7 and K8) at M = 655,360, IN=256, G=1024 and G=768, TF32 off,
   every element within f32 reassociation of torch.matmul + b (K 2^-23
   sum |x w| and one rounding), timed over 10 runs alternated with
   torch.addmm in f32 (its library time), with its bound (operations:
   5.13 ms at G=1024) and ptxas's registers and spills.
   The bf16 stream (--fast): the tensor-core bf16 affine alone (wgmma on
   TMA tiles) at M = 655,360 (T=2560 x B=256), IN=256, G=1024 and G=768,
   and at runnie's M (13,108 x 24), G=1024, every element
   within one bf16 ulp of its plain version (f32 product, TF32 off, one
   rounding) except where the f32 sum cancels below the error of its K
   products summed in another order, the elements that differ counted,
   timed over 10 runs alternated with torch.addmm in bf16 (its library
   time), its bound (bytes: ~0.50 ms at G=1024) and ptxas's registers and
   spills; its wmma path (shapes off the TMA grid) at (300, 12, 40) by the
   same rule, each on its own launch counter; K1-bf16 and K7-bf16 (T=2560, B=256, IN=H=256, both directions,
   ragged lengths including 0 and T; K1-bf16 also at T=13,108, B=24)
   within 1e-2 of their plain bf16 versions (the bit-equal share logged)
   and inside the JAX package's band for the stream against the f32
   kernels on the same inputs (max |delta| <= 0.05, mean < 0.01), each
   timed over 10 runs alternated with its f32 kernel, the bf16 affine
   alone and the f32 recurrence alone (K12): its time a step and the split
   between affine and recurrence; its bound the bf16 affine's operations
   at the tensor rate plus the recurrence's at the f32 rate.  K8-bf16
   (T=2560, B=256, both directions, ragged lengths): h within 1e-2 and c
   within 1e-2 max(1, |c|) of the plain version, h bit-equal to K1-bf16's,
   timed alternated with K1-bf16 and cuDNN's training-mode forward (its
   library time).  The one-pass affine with an f32 output (precision
   default on the f32 stream) at M = 655,360, G=1024 and 768 within f32
   reassociation of its plain version, timed beside the bf16-output kernel
   and torch.addmm in bf16 (its library time).  The rnn-default variants of
   K1, K8 and K7 (csrc/lstm_p1.cu, grumod_p1.cu: the one-pass step product)
   on the f32 stream (f32 and one-pass affine) and the bf16 stream
   (P1_CASES: the f32 affine both ways, the others one way each), each
   within 1e-2 max(1, |value|) of its plain twin, its mean
   within 1e-4 and its mean over the first 16 steps within P1_EARLY, while
   the same layer's f32-step kernel (the control) lies at least 3 P1_EARLY
   from that twin over those steps; timed alternated with the control on
   each stream, a row for each stream (no library call: null; the bound
   counts the one-pass products as bf16 tensor operations).  All three
   (csrc/cluster_rnn_mma.cuh, the tensor-core step) also at every rows a
   cluster (B = 1 ... 257, T = 40-64, both streams and directions):
   K8-default's h bit-equal to K1-default's, h (and c) inside the same
   band, the control at least 3 P1_EARLY outside, each band over at least
   128 rows (a smaller B runs a batch of that many, B rows a launch).  The
   rnn-high variants of K1, K8 and K7 (csrc/lstm_h3.cu, grumod_h3.cu: the
   three-pass step product on the tensor cores) by the same plan: T=2560,
   B=256, both streams (and the one-pass affine), both directions, each
   within H3_MAX = 1e-4 of its plain twin on the f32 stream (1e-2
   max(1, |value|) on the bf16 stream) and within H3_EARLY over the first
   16 steps, the one-pass kernel (the control) at least 3 H3_EARLY from
   the twin there; a crafted probe (iW = 0, one bias a gate, sW entries
   with large bf16 remainders, 4 steps) where the three-pass kernel meets
   its twin while the f32-step and one-pass kernels miss it by their
   plain versions' distances; timed alternated with the f32-step and
   one-pass kernels on each stream (rows with a null library time); and
   at every rows a cluster, K8-high3's h bit-equal to K1-high3's.
3. Main paths, full width, synthetic weights.  Through
   flappie_tpu_torch.cli.flappie.main, default flags and then --viterbi:
   r941_native on 64 seeded synthetic fast5 reads of ~100k samples
   (three 256-chunk batches of 12800 samples) and 16 of <= 12.8k samples
   (the bucket path), then fb once more under FLAPPIE_TPU_SCANB_FB=fused
   (K9), under FLAPPIE_TPU_CRF_IMPL=pallas (K11) and under
   FLAPPIE_TPU_CONV_IMPL=fast and =pallas (K10 once a program), each held
   to the default fb run; r941_5mC on 24 reads of 40k-60k samples (two
   256-chunk batches of 5120 samples) and 8 of 2k-5k samples, fb once
   more under FLAPPIE_TPU_CONV_IMPL=pallas (no K10: one strided conv);
   for each, transitions(rnn_impl="scan") on one full chunk batch with
   ragged lengths (one K12 a layer, within 1e-4 of the fused path, the
   Viterbi paths equal) and for r941_native the conv stack alone timed
   under each conv impl, the pallas stack split into K10 and the strided
   conv.  Through
   flappie_tpu_torch.cli.runnie.main: rle_r941_native on 32 reads of
   20k-60k samples and 8 of 3k-12k (bucketed batches of up to 32 reads,
   up to ~13.1k blocks a read), fb and --viterbi, each under the
   default impl and under pallas, the .run records of the two impls held
   to each other (equal, or base and dwell equal with shape and scale
   within 2e-5), and fb under FLAPPIE_TPU_CONV_IMPL=pallas (K10 once a
   program) held to the default fb run by each record's run bases
   (identity >= 99%, run count within 1%: the two convs' last bits move
   the fb decode's near ties) and the heaviest program's transitions
   under both convs within 1e-4.  Every CLI run sets the three knobs
   (their defaults unless the run is a knob's); every launch counter is zeroed just before each
   run and read just after and must equal the count the reads imply (an
   f32 layer's affine counts on affine_f32 beside its layer; no run takes
   the bf16 affine's wmma path); one
   FASTQ or .run record per read; 4 reads of each model held against
   the port's own CPU path (FASTQ: identity >= 99.5%, |score delta| <=
   1e-4; .run: the rule above); runnie's heaviest program (bucket 65536,
   24 reads) decoded on the card and on the CPU from the same
   transitions under each impl (--viterbi paths bit-equal; fb: the
   Viterbi over the card's posterior bit-equal, the CPU's own fb path
   other in at most 1% of the blocks, the scans' drift logged).
   r941_native's fb run sets FLAPPIE_TPU_PHASES (timing.py's accounting
   reset just before): each host phase's wall and calls are logged
   beside the run's wall and, after its profiled run, beside the device
   busy share.  The same reads once more with --trace (and its phase
   dump): the FASTQ byte-equal to the run without it, the file read back
   through hdf5_min and trace_view.iter_traces (the card's host has no
   h5py) with one group a record, a float32 signal of the read's trimmed
   length and a uint8 trace of [nblock + 1, 8], each row after the first
   summing to 255 +- 4, both walls and the file's size logged; the CPU
   subset run writes its own trace file, whose signals must equal the
   card's and traces lie within one count.  Then --chunk 0: the 80 reads
   whole through the bucket programs (launch counts as those imply), and
   4 reads (two of 20k-32k samples, two short) on the card and on the
   CPU path, held by the band.  The device time of one full chunk batch
   (10 runs); one more fb run of each
   model under torch.profiler (its device busy share; r941_native's once
   more with host activity: the host calls of the longest self time),
   and of runnie once more under
   FLAPPIE_TPU_CRF_IMPL=pallas (K11's kernel time), runnie's runs with
   their tracebacks replayed under the profiler: the traceback kernel's
   device time beside the glue around it (layout copies, casts, flips).
   Then flappie-serve (flappie_tpu_torch.cli.serve), in this process:
   serve.main for r941_native at full width with --warmup and
   FLAPPIE_TPU_PHASES (the time to its first request logged), fed on
   stdin a directory of 10 seeded reads
   (6 chunked, 4 bucketed), a missing path, the same directory again and
   a second directory, its phase dump logged at server exit; each
   request's ack (reads, called, wall=) checked
   and its wall logged, request 1 beside requests 2-4; each FASTQ
   byte-equal to the flappie CLI's on the same files in this process
   (and request 1's to a fresh CLI process's, whose wall is logged), the
   repeat to the first, the missing path acked with reads=0; the launch
   counts of the warmup and the four requests equal to what their
   programs imply (5 K1, 3 K3/K4, 1 K5, 1 K6 a program).  Then serve_watch with --multi --qcal
   1.1:-0.5 --output-dir: a multi-read file of 6 reads (written by
   hdf5_min) dropped into the watched directory is published once, its
   records the CLI's --multi records with the calibrated qualities, a
   STOP file ends the server, and its launch counts are checked too.
   Then --fast (the bf16 stream): r941_native fb on its 80 reads,
   r941_5mC and runnie fb on theirs, each --fast run alternated with the
   exact run twice (walls side by side), exact launch counts (5
   K1-bf16 or K7-bf16 and the bf16 affine a program, no f32 K1 or K7),
   the exact runs byte-equal to the main path's, each mode's output equal
   across rounds, FLAPPIE_TPU_RNN_STREAM never set, the --fast records'
   identity to the exact ones logged; one flappie-serve request on a warm
   --fast server beside a warm exact one (alternated, counted), its
   records byte-equal to the CLI's --fast records; the device-only time
   of one 256-chunk batch under bf16 beside f32 (in each main path's
   chunk-program timing); and the accuracy band: 64 seeded reads of
   16k-28k samples basecalled exact and --fast through the CLIs for
   r941_native, r941_5mC and rle_r941_native (runnie's run-length calls
   expanded), each read's identity by flappie_tpu_torch.accuracy: p5,
   p50, min, identical reads, reads missing from --fast, the largest
   phred shift where the lengths align; a missing read or a median under
   90% fails the run (a broken kernel; the weights are synthetic).  The
   default band: the same 64 reads with FLAPPIE_TPU_MATMUL_PRECISION and
   FLAPPIE_TPU_RNN_PRECISION at default (r941_native and r941_5mC, each
   on the f32 stream and under --fast), exact launch counts (5 one-pass recurrences a
   program with their affines), each against the exact run by the same
   band and gate.  The high band: the same 64 reads at
   FLAPPIE_TPU_RNN_PRECISION=high (r941_native and r941_5mC, each on the
   f32 stream and under --fast), exact launch counts (5 three-pass
   recurrences a program with their affines), each against the run of its
   stream at the unset level: no read missing, on the f32 stream every
   read's identity >= 99.5%, under --fast (bf16 outputs a layer) the
   median >= 99% and every read >= 98% (HIGH_FAST_IDENTITY, set by
   high_witness.py between a correct f32 step's distance and the one-pass
   step's), which the control, the default band's --fast run against the
   same --fast run, must fail; the byte-equal records and the largest
   |score delta| logged.
   Then the sloika-era graphs at full width (conv winlen 19, 1 -> 256,
   stride 2; five recurrent layers of 256): for each flavour a seeded
   sloika pickle whose classes cannot be imported when it is loaded,
   converted in process by flappie-torch-convert sloika2npz and read by
   load_sloika_npz.  flipflop_gru (five residual 2-matrix GRUs, a plain
   time loop) and flipflop_grumod (five GRU-mods, K7) each basecall 32
   reads through Basecaller(model=cfg, params=params) on the card (fb,
   2560-block chunks, one 256-chunk batch) with exact launch counts and
   their wall, then 4 short reads held to the port's CPU path by the
   band.  runlength: transitions over one full batch (256 x 5120
   samples, 2560 blocks; 5 K7), then rle_v1_viterbi and rle_v1_posterior
   under the default CRF impl (K3/K4, K5, K6 at S=4) and under pallas
   (K11 at S=4), exact counts, the path and score equal under both and 2
   reads held to the CPU path; each S=4 kernel held to its plain version
   on that batch's V1 chain (K3/K4 and K11's forward within rtol 1e-5,
   K5's and K11's Viterbi and both tracebacks bit-equal), timed with its
   bound, K3 and K11's scans also in the builds of 1, 2 and 4 chain
   warps.  Beside these runs, in the background, npz2header ->
   header2npz -> npz2header for r941_native and r941_5mC at full width
   (the headers byte-equal), and torch2npz of a taiyaki state dict.
   Then the multi-device and multi-process runs, on 16 of r941_native's
   reads (its first 8 long ones and 8 short ones, at least two a bucket):
   mesh -- DistributedBasecaller over [cuda:0, cuda:0] (two weight
   replicas, two dispatch threads on the one card: the sharding path,
   not a speed-up) against the plain Basecaller, fb and --viterbi, each
   warmed up once, by the band, in input order, every dispatch in two
   shards, every launch counter twice the plain run's, both walls
   logged; the CLI's --mesh 2 refused with rc 1 and the JAX CLI's
   message; tp -- the mesh's model axis: DistributedBasecaller over a
   (1, 4) mesh on [cuda:0] x 4 (every rnn*/ff leaf in four column shards,
   each held to its own columns and nothing more, gathered a layer at a
   time) byte-equal to the plain fb run with its launch counts, and over
   a (2, 2) mesh in the band, in input order, twice the launches; three
   r941_native training steps (batch 32, 512 blocks) on a (1, 4) mesh
   against one device, both under torch's deterministic algorithms (with
   the defaults two one-device runs differ): every loss within 1e-5
   relative, the launches equal, every parameter and Adam moment
   bit-equal, the moments beside their shards; library -- Basecaller.call_batch
   on 8 short reads byte-equal to the f32 bucket program's output for
   them, and basecall_read_chunked on two long synthetic reads (60,000
   and 120,000 samples, chunk 16000, overlap 2000: one forward batch of
   chunks, the stitched row decoded as one) against the port's CPU run
   of the same call by the band, with K1's and the decode's launches on
   each read; dispatch -- the Basecaller's public packed-dispatch entries
   on r941_native at bench.py's geometry (3 chunk batches of 256 x 12,800
   samples, 3 full-read batches of 64 x 65,536, ragged; ADC whose steps
   past int8 are as rare as a real signal's): every dispatch_packed_*
   single entry byte-equal to its private program on the same buffer,
   each grouped entry (G = 3) byte-equal to its batches' single
   dispatches (the d8 groups to the i16 singles), the d8 entries to the
   i16 entries, the f32 entries held to the i16 entries by the band (the
   byte-equal rows logged), call_chunk_batch_device + unpack_chunk_outputs
   to the f32 chunk program field by field, np.asarray(handle) beside
   handle.result(), exact launch counts (5 K1, 3 K3/K4, 1 K5, 1 K6 a
   batch), each entry's wall from dispatch to np.asarray beside its
   program's device-only time, both in Msamples/s; and a
   DistributedBasecaller over [cuda:0, cuda:0] through
   dispatch_packed_chunk_i16 and its grouped form: twice the launches, in
   the band against the one-device singles, wire_summary naming both
   programs on two devices; launch -- python -m flappie_tpu_torch.parallel.launch
   --nproc 2 with --trace (both workers on cuda:0) against the CLI in
   this process: the merged FASTQ in input order and in the band, the
   merged trace's groups the plain run's (signals equal, traces within
   one count), no part file left, both walls; dp-train --
   flappie_tpu_torch.train.distributed with 2 ranks over gloo on cuda:0
   at r941_native's training shape (batch 32, 16 a rank, 512 blocks), 3
   steps, against one process taking the same steps on the whole batch:
   every loss within 1e-5 relative, the ranks' parameters equal after
   every step, 5 K8 and 2 K3/K4 a step in each rank and in the one
   process, the step walls; profile -- the CLI with --jax-profile DIR:
   a Chrome trace naming cluster_rnn_kernel, affine_kernel,
   crf_sum_kernel, crf_viterbi_kernel and traceback_kernel, the FASTQ
   byte-equal to the run without it.
   Then the knobs of the JAX package, on the same 16 reads, each run's
   wall, dispatches (Basecaller.dispatch_stats) and launches logged
   beside the default fb (and --viterbi) run of this call:
   FLAPPIE_TPU_CRF_IMPL=seg (fb and --viterbi) and =scan, and
   FLAPPIE_TPU_SCANB_KERNELS=off, each in the band and launching no CRF
   kernel; FLAPPIE_TPU_UPLOAD=d8 (a batch with a row past its exception
   slots takes the i16 wire), FLAPPIE_TPU_DISPATCH_GROUP=2, the upload
   and collector threads, FLAPPIE_TPU_PREWARM=1 and
   FLAPPIE_TPU_PREPROCESS_WAVE=4, each byte-equal, and
   FLAPPIE_TPU_UPLOAD=f32 byte-equal or in the band (the reason logged);
   DistributedBasecaller over [cuda:0, cuda:0] under d8 and groups of 2,
   in the band against the one-device run, its grouped dispatches in two
   shards; d8 on 4 reads whose steps past int8 are as rare as a real
   signal's, byte-equal, the d8 chunk and bucket programs run; runnie
   under seg on 8 of its reads, each record's run bases within identity
   99.5% and its run count within 1% of the default impl's, at least 4
   records with base and dwell equal and shape and scale within 2e-5;
   native.py built on the card's host before these runs, preprocess_batch
   and encode_d8 bit-equal to numpy on the 80 r941_native reads, each
   encoder timed.
4. Training: the autograd Functions of the training path against
   autograd through the plain versions (T=512, B=32, H=256; every
   gradient within 1e-3 of its max |value|; K10's Function at B=32,
   T=2560 samples, against autograd through its plain chain, the same
   band) and one layer's adjoint
   backward timed beside cuDNN's; r941_native trained at full width for
   40 steps (batch 32, 2560-sample chunks of 96 synthetic reads labelled
   on the card by a teacher's Viterbi paths, Adam at lr 2e-4): every loss
   finite, the last 3 below 0.6x the first 3, exact launch counts (5 K8
   and 2 K3/K4 a step, no K1), the median step split into forward and
   backward, one step against the port's CPU path (loss within 1e-5
   relative, gradients within 1e-3); 3 steps under
   FLAPPIE_TPU_CONV_IMPL=pallas (one K10 a step, the first loss within
   1e-5 relative of the default conv's on the same batch and weights);
   the same 40 batches under the bf16 stream (make_train_step(...,
   stream=torch.bfloat16)): the same loss gate, exact counts (5 K8-bf16,
   5 bf16 affines, 2 K3/K4 a step, no f32 K8), one step of 8 rows against
   the CPU path (loss within 1e-3 relative, gradients within 1e-2), one
   step at FLAPPIE_TPU_GRAD_PRECISION=default (the same loss, gradients
   within 5e-2 of the f32 adjoint's and not equal to them), and 3 steps of K8 at
   FLAPPIE_TPU_RNN_PRECISION=default and 3 at =high on each stream, counted
   (at high each loss within 1e-3 relative of the f32 step's);
   3 CTC steps on r941_native and 3
   steps on r941_5mC (K7 under autograd) with exact counts; the train
   state saved and restored bit for bit, and the trained student
   basecalling 4 reads through the CLI's --checkpoint.
5. The card line, one JSON line with every kernel's numbers, and the
   last line {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.  Writes only under build/
in the checkout (build/chip_smoke/ and the kernels' builds).  The whole
run with every phase above took 568-750 s of command time on an H100 80GB
HBM3 at 700 W (745 s with the knobs phase, 33 s of it), 817-869 s with the
three-pass phases, 722 s once the plain twins were timed on the bands'
own runs and check_layer_p1 held P1_CASES; it should stay well inside
its 1200 s limit (at most ~60-65% of it).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shlex
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "chip_smoke")

# Published peaks (NVIDIA data sheets, dense): f32 outside the tensor
# cores and HBM bandwidth, for the SXM part (at its 700 W limit) and the
# PCIe part, so a PCIe card is not held to SXM numbers.
PEAKS = {
    "sxm": {"f32_ops": 67e12, "bf16_ops": 989e12, "bytes": 3.35e12},
    "pcie": {"f32_ops": 51e12, "bf16_ops": 756e12, "bytes": 2.0e12},
}


def log(msg: str) -> None:
    print(msg, flush=True)


# seconds of each phase of this run (logged before the result)
phase_seconds: dict = {}


def timed(name: str, fn, *args):
    """fn(*args), its seconds added to phase_seconds[name]."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        phase_seconds[name] = phase_seconds.get(name, 0.0) + time.perf_counter() - t0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


# cycles of the device sleep queued ahead of a timed call that takes
# microseconds (~1 ms of the H100's clock): the host's own work for the call
# (the wrapper, the launch) then runs while the device sleeps, and the events
# time the device's work alone
LEAD_CYCLES = 2_000_000


def cuda_ms(torch, fn, reps: int, lead: bool = False) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after one
    warm-up; ``lead``: each run behind a device sleep (LEAD_CYCLES)."""
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if lead:
            torch.cuda._sleep(LEAD_CYCLES)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def event_ms(torch, fn) -> tuple:
    """(fn(), its CUDA-event time in ms): one run, started on an idle
    device (the caller warms ``fn`` up)."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def alternated_ms(torch, fns: dict, reps: int, lead: bool = False) -> dict:
    """CUDA-event times of each function of ``fns`` over ``reps`` rounds
    after one warm-up each; within a round the functions take turns, in
    reverse order every other round (``lead``: each run behind a device
    sleep, as in cuda_ms): {name: [ms, ...]}."""
    for fn in fns.values():
        fn()
    names = list(fns)
    times = {k: [] for k in names}
    for i in range(reps):
        for k in names if i % 2 == 0 else names[::-1]:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            if lead:
                torch.cuda._sleep(LEAD_CYCLES)
            e0.record()
            fns[k]()
            e1.record()
            torch.cuda.synchronize()
            times[k].append(e0.elapsed_time(e1))
    return times


def spread(ts: list) -> str:
    return (f"median {statistics.median(ts):.3f} ms (min {min(ts):.3f}, max {max(ts):.3f}, "
            f"{len(ts)} runs)")


# runs a side of every kernel-against-cuDNN comparison
ALTERNATED_REPS = 10


def bound(bytes_: float, ops: float, peak: dict, bf16_ops: float = 0.0):
    """The larger of the bytes' time at the memory rate and the
    operations' (``ops`` f32 outside the tensor cores, ``bf16_ops`` on
    them), in ms, and which it is."""
    t_bytes = bytes_ / peak["bytes"] * 1e3
    t_ops = (ops / peak["f32_ops"] + bf16_ops / peak["bf16_ops"]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: kernels --------------------------------------------------------


def row(name, kid, source, replaces, run, counter, **numbers) -> dict:
    """One kernel's line: ``run`` is the model whose fb main-path run
    supplies its launch count, read from counter ``counter``."""
    return dict(name=name, kid=kid, route="cuda", source="flappie_tpu_torch/csrc/" + source,
                replaces="flappie_tpu/ops/" + replaces, run=run, counter=counter, **numbers)


def cudnn_gru_order(w, H: int):
    """GRU-mod gate order (z, r, hbar) -> cuDNN's (r, z, n) along dim 0:
    the inverse of the taiyaki converter's cudnn-to-guppy reordering."""
    import torch

    return torch.cat([w[H : 2 * H], w[:H], w[2 * H :]])


# kind -> (id, gates, wrapper in ops/rnn_cuda.py, source, TPU kernel, run and
# counter that supply the launch count)
LAYER_KERNELS = {
    "lstm": ("K1", 4, "lstm_layer_tm", "lstm.cu", "rnn_pallas.py:273", "r941_native",
             "lstm_layer"),
    "grumod": ("K7", 3, "grumod_layer_tm", "grumod.cu", "rnn_pallas.py:290", "r941_5mC",
               "grumod_layer"),
    "lstm_train": ("K8", 4, "lstm_layer_tm_train", "lstm.cu", "rnn_pallas.py:278",
                   "r941_native_train", "lstm_layer_train"),
}


def check_layer(torch, peak: dict, gen, kind: str) -> dict:
    """K1 (kind "lstm"), K7 ("grumod") or K8 ("lstm_train", which also
    returns the cell state; its h must be K1's bit for bit) at T=2560,
    B=256, IN=H=256."""
    from flappie_tpu_torch.ops import rnn_cuda

    dev = torch.device("cuda")
    kid, gates, wrapper, source, replaces, run, counter = LAYER_KERNELS[kind]
    fn, plain = getattr(rnn_cuda, wrapper), getattr(rnn_cuda, wrapper + "_plain")
    train = kind == "lstm_train"
    T, B, IN, H = 2560, 256, 256, 256
    G = gates * H
    lengths = torch.randint(1, T, (B,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = T, 0
    mask = (torch.arange(T, device=dev)[:, None] < lengths[None, :])[..., None]
    x = torch.randn(T, B, IN, generator=gen, device=dev) * mask
    iW = torch.randn(IN, G, generator=gen, device=dev) / IN ** 0.5
    sW = torch.randn(H, G, generator=gen, device=dev) / H ** 0.5
    if gates == 4:
        b = torch.zeros(G, device=dev)
        b[H : 2 * H] = 1.0
    else:
        # the candidate third far from zero: xa_h summed into the
        # recurrent product would show
        b = torch.randn(G, generator=gen, device=dev) * 0.2
        b[2 * H :] += 0.75
    err = 0.0
    for backward in (False, True):
        got = fn(x, iW, b, sW, backward, lengths)
        want = plain(x, iW, b, sW, backward, lengths)
        if train:
            h1 = rnn_cuda.lstm_layer_tm(x, iW, b, sW, backward, lengths)
            torch.cuda.synchronize()
            if not torch.equal(got[0], h1):
                raise AssertionError(f"K8 lstm_layer_train (backward={backward}): h is not "
                                     "K1's h bit for bit")
        else:
            got, want = (got,), (want,)
        torch.cuda.synchronize()
        err = max([err] + [(g - w).abs().max().item() for g, w in zip(got, want)])
    if not err <= 1e-4:
        raise AssertionError(f"{kid} {kind}_layer: max |delta| {err} > 1e-4")
    plain_ms = cuda_ms(torch, lambda: plain(x, iW, b, sW, True, lengths), 1)
    # yardstick: one cuDNN call on the packed ragged batch, forward
    # direction; zero-length rows count as one step, which
    # pack_padded_sequence requires.  nn.LSTM's gate order (i, f, g, o)
    # is K1's (u, f, g, o); nn.GRU's n = tanh(W_in x + b_in + r*(W_hn h +
    # b_hn)) is GRU-mod's candidate when b_hh = 0, after reordering the
    # gates to (r, z, n).  For K8 the call is cuDNN's training-mode
    # forward: inputs that require gradients, so it keeps what its
    # backward needs.
    if gates == 4:
        ref = torch.nn.LSTM(IN, H).to(dev)
        w_ih, w_hh, b_ih = iW.T, sW.T, b
    else:
        ref = torch.nn.GRU(IN, H).to(dev)
        w_ih, w_hh, b_ih = (cudnn_gru_order(w, H) for w in (iW.T, sW.T, b))
    with torch.no_grad():
        ref.weight_ih_l0.copy_(w_ih)
        ref.weight_hh_l0.copy_(w_hh)
        ref.bias_ih_l0.copy_(b_ih)
        ref.bias_hh_l0.zero_()
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        x.clone().requires_grad_(train), lengths.clamp(min=1).cpu(), enforce_sorted=False)
    with torch.set_grad_enabled(train):
        lib_out, _ = torch.nn.utils.rnn.pad_packed_sequence(ref(packed)[0], total_length=T)
        times = alternated_ms(torch, {"kernel": lambda: fn(x, iW, b, sW, True, lengths),
                                      "cudnn": lambda: ref(packed)}, ALTERNATED_REPS)
    ms, library_ms = (statistics.median(times[k]) for k in ("kernel", "cudnn"))
    got = fn(x, iW, b, sW, False, lengths)
    got = got[0] if train else got
    lib_err = ((lib_out.detach() - got) * mask).abs().max().item()
    log(f"{kid} library call computes the same function: max |cuDNN - kernel| {lib_err:.2e} "
        "over the valid steps (forward)")
    log(f"{kid} {kind}_layer at T={T}, B={B}, alternated with cuDNN: kernel "
        f"{spread(times['kernel'])}; cuDNN {spread(times['cudnn'])}; kernel/cuDNN "
        f"{ms / library_ms:.3f}")
    nvalid = int(lengths.sum().item())
    layer_bytes = 4 * (nvalid * IN + IN * G + G + H * G + B + T * B * H * (2 if train else 1))
    layer_ops = 2 * nvalid * (IN + H) * G
    bms, by = bound(layer_bytes, layer_ops, peak)
    return row(counter, kid, source, replaces, run, counter, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)


# K1's other main-path shapes: (what, T, B)
K1_SHAPES = (("runnie's heaviest program", 13_108, 24), ("the training batch", 512, 32))


def time_lstm_shapes(torch, gen) -> None:
    """K1 at runnie's heaviest program (T=13,108, B=24) and at the
    training shape (T=512, B=32), IN=H=256, ragged lengths including T:
    held within 1e-4 of its plain version, then timed alternated with
    cuDNN on the same packed batch, with the recurrence alone (K12 over
    the same affine, every step valid) for the per-step time; logged with
    the cluster plan."""
    from flappie_tpu_torch.ops import rnn_cuda

    dev = torch.device("cuda")
    IN = H = 256
    for what, T, B in K1_SHAPES:
        lengths = torch.randint(T // 2, T, (B,), generator=gen, device=dev, dtype=torch.int32)
        lengths[0] = T
        mask = (torch.arange(T, device=dev)[:, None] < lengths[None, :])[..., None]
        x = torch.randn(T, B, IN, generator=gen, device=dev) * mask
        iW = torch.randn(IN, 4 * H, generator=gen, device=dev) / IN ** 0.5
        sW = torch.randn(H, 4 * H, generator=gen, device=dev) / H ** 0.5
        b = torch.zeros(4 * H, device=dev)
        b[H : 2 * H] = 1.0
        err = 0.0
        for backward in (False, True):
            got = rnn_cuda.lstm_layer_tm(x, iW, b, sW, backward, lengths)
            want = rnn_cuda.lstm_layer_tm_plain(x, iW, b, sW, backward, lengths)
            torch.cuda.synchronize()
            err = max(err, (got - want).abs().max().item())
        if not err <= 1e-4:
            raise AssertionError(f"K1 at {what} (T={T}, B={B}): max |kernel - plain| {err} > 1e-4")
        ref = torch.nn.LSTM(IN, H).to(dev)
        with torch.no_grad():
            ref.weight_ih_l0.copy_(iW.T)
            ref.weight_hh_l0.copy_(sW.T)
            ref.bias_ih_l0.copy_(b)
            ref.bias_hh_l0.zero_()
        packed = torch.nn.utils.rnn.pack_padded_sequence(x, lengths.cpu(), enforce_sorted=False)
        xa = (x.transpose(0, 1) @ iW + b).contiguous()  # [B, T, 4H]
        with torch.no_grad():
            times = alternated_ms(torch, {
                "kernel": lambda: rnn_cuda.lstm_layer_tm(x, iW, b, sW, True, lengths),
                "recurrence": lambda: rnn_cuda.lstm_seq_cuda(xa, sW),
                "cudnn": lambda: ref(packed)}, ALTERNATED_REPS)
        ms, rec_ms, lib_ms = (statistics.median(times[k]) for k in ("kernel", "recurrence",
                                                                    "cudnn"))
        plan = rnn_cuda.cluster_info("lstm_layer", B)
        log(f"K1 at {what} (T={T}, B={B}, IN=H={H}): R={plan['R']} rows a cluster, "
            f"{plan['clusters']} clusters (the card holds {plan['max_active_clusters']}); max "
            f"|kernel - plain| {err:.2e}; kernel {spread(times['kernel'])} = "
            f"{1e3 * ms / T:.3f} us a step with its affine; the recurrence alone (K12) "
            f"{spread(times['recurrence'])} = {1e3 * rec_ms / T:.3f} us a step; cuDNN on the "
            f"same packed batch {spread(times['cudnn'])}; kernel/cuDNN {ms / lib_ms:.3f}")


def log_cluster_plans() -> None:
    """Each instantiation of the cluster recurrence: the C side's plan
    (rows a cluster, clusters, shared bytes) held to ops/rnn_cuda.py's
    _cluster_plan, and cudaOccupancyMaxActiveClusters."""
    from flappie_tpu_torch.ops import rnn_cuda

    for kind in rnn_cuda._INFO:
        got = []
        # one batch for each rows-a-cluster instantiation (R = 1 ... 20)
        for B in (1, 16, 32, 100, 150, 240, 256):
            info = rnn_cuda.cluster_info(kind, B)
            want = rnn_cuda.info_plan(kind, B)
            if (info["R"], info["clusters"], info["smem"]) != want:
                raise AssertionError(f"cluster plan of {kind} at B={B}: C side {info}, "
                                     f"_cluster_plan {want}")
            got.append(f"R={info['R']}: {info['smem']} B shared, at most "
                       f"{info['max_active_clusters']} clusters at once")
            # the three-pass step's shared bytes must still let a chunk
            # batch's clusters run at once
            if kind.endswith("_h3") and B == 256 and info["max_active_clusters"] < info["clusters"]:
                raise AssertionError(f"{kind} at B=256: {info['clusters']} clusters, the card "
                                     f"holds {info['max_active_clusters']} at once")
        log(f"cluster recurrence {kind} (H=256): " + "; ".join(got))


# CUDA-event runs behind each batch-minor scan time
SCAN_REPS = 10


def scan_step(ms: float, T: int, S: int, B: int, chains: int = 1) -> str:
    """A chain kernel's time, per step, and the grid it launched
    (flappie_crf_scan_info; K9 launches one row of CTAs a chain)."""
    from flappie_tpu_torch.ops import crf_bm_cuda

    p = crf_bm_cuda.scan_info(S, B)
    return (f"{ms:.4f} ms (median of {SCAN_REPS}) = {1e6 * ms / T:.1f} ns a step; "
            f"{chains * p['ctas']} CTAs of {p['W']} warps x {p['R']} reads, "
            f"{p['smem']} B of ring a CTA")


# Builds of the chain scans beside the path's, timed against it: crf_scan.cu
# at 1, 2 and 4 chain warps a CTA (-DSCAN_WARPS=n, its kWarps) and crf_bt.cu
# at 1, 2 and 4 (-DBT_WARPS=n, its kBtWarps), each into
# build/flappie_tpu_torch/<variant>/
WARP_SIZES = (1, 2, 4)
VARIANTS = {**{f"scan_w{w}": ("crf_scan", (f"-DSCAN_WARPS={w}",)) for w in WARP_SIZES},
            **{f"bt_w{w}": ("crf_bt", (f"-DBT_WARPS={w}",)) for w in WARP_SIZES},
            "conv12_flat": ("conv12", ("-DCONV12_PERSIST=0",)),
            "conv12_direct": ("conv12", ("-DCONV12_BULK=0",)),
            "conv12_precise": ("conv12", ("-DCONV12_FAST_SWISH=0",))}

# argument kinds of the C entry points (P pointer, I int) that a build loaded
# here may export: the wrappers' own (ops/crf_bm_cuda.py, ops/crf_cuda.py)
ENTRY_ARGS = {
    "flappie_crf_scan_info": "IIP", "flappie_crf_sum": "PPPIIIIP",
    "flappie_crf_fwdbwd": "PPPPIIIP", "flappie_crf_viterbi": "PPPPPIIIP",
    "flappie_crf_traceback": "PPPPIIIP", "flappie_crf_bt_info": "IIP",
    "flappie_crf_bt_fwd": "PPPIIIP", "flappie_crf_bt_viterbi": "PPPPPIIIP",
    "flappie_crf_bt_traceback": "PPPPIIIP", "flappie_crf_traceback_info": "IIIP",
    "flappie_crf_bt_traceback_info": "IIIP", "flappie_conv12": "PPPPPPPIIP",
    "flappie_conv12_info": "IIP",
}

# nvcc's output of each build loaded by finish_builds, and its seconds
# from its start to its exit, by variant
variant_log: dict = {}
variant_seconds: dict = {}


def start_builds(cuda_build, variants: dict, csrc: str = None) -> dict:
    """Start one nvcc for each variant {name: (source, (-D flags))} of
    csrc/<source>.cu (``csrc``: another checkout's sources, as
    compare_scans.py builds them): {name: (library, process, start, wait)},
    each process's output read from its start (cuda_build.read_async)."""
    jobs = {}
    for name, (src, flags) in variants.items():
        so = os.path.join(cuda_build.BUILD_DIR, name, f"lib{src}.so")
        os.makedirs(os.path.dirname(so), exist_ok=True)
        cu = os.path.join(csrc or cuda_build.CSRC_DIR, src + ".cu")
        start = time.perf_counter()
        proc = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs[name] = so, proc, start, cuda_build.read_async(proc)
    return jobs


def finish_builds(jobs: dict) -> dict:
    """Wait for start_builds' builds and load them, their entry points
    typed as the wrappers type theirs: {name: library}."""
    import ctypes

    libs = {}
    for name, (so, proc, start, wait) in jobs.items():
        out, err, end = wait()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc for build {name} failed:\n{err}")
        variant_log[name] = out + err
        variant_seconds[name] = end - start
        lib = ctypes.CDLL(so)
        for fn, kinds in ENTRY_ARGS.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = [ctypes.c_void_p if k == "P" else ctypes.c_int
                                             for k in kinds]
                getattr(lib, fn).restype = ctypes.c_int
        lib.flappie_cuda_error_string.argtypes = [ctypes.c_int]
        lib.flappie_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


@contextlib.contextmanager
def using_lib(source: str, lib):
    """The port's wrappers of csrc/<source>.cu launch ``lib``'s kernels
    (another build of a source with the same C interface) inside the
    block."""
    from flappie_tpu_torch.ops import cuda_build

    own = cuda_build.load(source)
    cuda_build._libs[source] = lib
    try:
        yield
    finally:
        cuda_build._libs[source] = own


def same(a, b) -> bool:
    """Bit-equal tensors, or tuples of them."""
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def time_builds(torch, source: str, libs: dict, fn, ref, what: str, T: int,
                lead: bool = False, unit: str = "step") -> dict:
    """``fn`` (a wrapper call) through each build of csrc/<source>.cu in
    ``libs`` ({label: library}; None: the path's own), each output
    bit-equal to ``ref`` (the path's output, itself held to its plain
    version), then timed alternated in one process (``lead``: behind a
    device sleep).  Logs each median over T ``unit``s and returns {label:
    median ms}."""
    from flappie_tpu_torch.ops import cuda_build

    libs = {k: lib or cuda_build.load(source) for k, lib in libs.items()}

    def run(lib):
        with using_lib(source, lib):
            return fn()

    for k, lib in libs.items():
        if not same(run(lib), ref):
            raise AssertionError(f"{what}, build {k}: not bit-equal to the path's output")
    times = alternated_ms(torch, {k: lambda lib=lib: run(lib) for k, lib in libs.items()},
                          SCAN_REPS, lead)
    log(f"{what}, each build bit-equal to the path's: " + "; ".join(
        f"{k}: {spread(ts)} = {1e6 * statistics.median(ts) / T:.{4 if unit == 'sample' else 1}f} "
        f"ns a {unit}"
        for k, ts in times.items()))
    return {k: statistics.median(ts) for k, ts in times.items()}


def ptxas_usage(text: str, entry: str) -> str:
    """Registers and spill stores of the kernels whose mangled names hold
    ``entry``, from nvcc -Xptxas -v output."""
    import re

    got, name, spill = [], None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if entry in m.group(1) else None
        elif name and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            got.append(f"{regs} registers, {spill} B spilled")
    return "; ".join(got) or "not logged"


def time_scan_warps(torch, libs: dict, dense, tvalid, k3, what: str) -> None:
    """K3 (forward) in the build of each CTA size, each output bit-equal to
    the path's K3 output ``k3`` (itself held to its plain version), timed
    alternated: the measurement behind kWarps in csrc/crf_scan.cu."""
    from flappie_tpu_torch.ops import crf_bm_cuda

    time_builds(torch, "crf_scan", {f"{w} chain warps": libs[f"scan_w{w}"] for w in WARP_SIZES},
                lambda: crf_bm_cuda.sum_states(dense, tvalid, False), k3,
                f"K3 at {what} by chain warps a CTA", dense.shape[0])


def bt_step(ms: float, T: int, S: int, B: int, kernel: str) -> str:
    """A K11 chain kernel's time, per step, the grid it launched
    (flappie_crf_bt_info) and its registers (ptxas)."""
    from flappie_tpu_torch.ops import crf_cuda, cuda_build

    p = crf_cuda.bt_info(S, B)
    regs = ptxas_usage(cuda_build.build_log.get("crf_bt", ""), f"{kernel}ILi{S}E")
    return (f"{ms:.4f} ms (median of {SCAN_REPS}) = {1e6 * ms / T:.1f} ns a step; "
            f"{p['ctas']} CTAs of {p['W']} warps x {p['R']} reads, {p['smem']} B of ring a CTA "
            f"(read stride {p['stride']} floats); {regs}")


def time_bt_builds(torch, libs: dict, dense, valid, rank, fwd, vit, what: str) -> None:
    """K11's forward and Viterbi scans through K11's other builds (chain
    warps a CTA), against the path's outputs."""
    from flappie_tpu_torch.ops import crf_cuda

    T = dense.shape[0]
    bt = {"path": None, **{k: lib for k, lib in libs.items() if k.startswith("bt_")}}
    time_builds(torch, "crf_bt", bt, lambda: crf_cuda.fwd_scan(dense, valid), fwd,
                f"K11 forward at {what} by build", T)
    time_builds(torch, "crf_bt", bt, lambda: crf_cuda.viterbi_scan(dense, valid, rank), vit,
                f"K11 Viterbi at {what} by build", T)


def profile_bwd_copy(torch, dense, valid, what: str) -> None:
    """K11's forward scan over the backward pass's input (the transposed,
    time-reversed view ops/crf.py crf_backward hands it) under
    torch.profiler: the device time a call of each kernel it runs, the copy
    that makes the view contiguous beside the scan."""
    from torch.profiler import ProfilerActivity, profile

    from flappie_tpu_torch.ops import crf_cuda

    rev, vrev = dense.flip(0).transpose(-1, -2), valid.flip(0)
    crf_cuda.fwd_scan(rev, vrev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(SCAN_REPS):
            crf_cuda.fwd_scan(rev, vrev)
        torch.cuda.synchronize()
    got = device_time(prof)
    if got is None:
        log(f"K11 backward-pass input at {what}: no device events recorded; not measured")
        return
    log(f"K11 backward-pass input at {what}, device ms a call (profiler, {SCAN_REPS} calls): "
        + "; ".join(f"{us / 1e3 / SCAN_REPS:.4f} {name[:70]}"
                    for name, us in sorted(got[2].items(), key=lambda kv: -kv[1])))


def log_scan_plans() -> None:
    """The chain scans' plan on the C side (flappie_crf_scan_info) held to
    ops/crf_bm_cuda.py's _scan_plan at the batches the paths run."""
    from flappie_tpu_torch.ops import crf_bm_cuda

    for S in (8, 10, 4):
        got = []
        for B in (1, 2, 3, 8, 24, 32, 256, 257):
            info = crf_bm_cuda.scan_info(S, B)
            want = crf_bm_cuda._scan_plan(S, B)
            if tuple(info.values()) != want:
                raise AssertionError(f"scan plan at S={S}, B={B}: C side {info}, "
                                     f"_scan_plan {want}")
            R, W, ctas, smem = want
            got.append(f"B={B}: {ctas} CTAs of {W}")
        log(f"batch-minor scans S={S}: {R} reads a warp, up to {W} chain warps and a producer "
            f"warp a CTA, {smem // W} B of ring a chain warp; " + ", ".join(got))


def log_bt_plans() -> None:
    """K11's chain scans' plan on the C side (flappie_crf_bt_info) held to
    ops/crf_cuda.py's _bt_plan at the batches the paths run."""
    from flappie_tpu_torch.ops import crf_cuda

    for S in (8, 10, 4):
        got = []
        for B in (1, 2, 3, 8, 24, 32, 256, 257):
            info = crf_cuda.bt_info(S, B)
            want = crf_cuda._bt_plan(S, B)
            if tuple(info.values()) != want:
                raise AssertionError(f"K11 plan at S={S}, B={B}: C side {info}, _bt_plan {want}")
            R, W, ctas, smem, P = want
            got.append(f"B={B}: {ctas} CTAs of {W}")
        log(f"K11 forward and Viterbi S={S}: {R} reads a warp, up to {W} chain warps and a "
            f"producer warp a CTA, {smem // W} B of ring a chain warp, reads {P} floats apart; "
            + ", ".join(got))


# (T, B) of the tracebacks' plans logged and held: the chunk programs, runnie's
# heaviest and a short bucket, and a batch past one read group a CTA slot
TB_PLAN_SHAPES = ((2560, 256), (13_108, 24), (2000, 8), (75, 40), (2560, 1100))


def log_tb_plans() -> None:
    """The tracebacks' plans on the C side (flappie_crf_traceback_info,
    flappie_crf_bt_traceback_info) held to ops/crf_bm_cuda.py's _tb_plan
    and ops/crf_cuda.py's _tb_bt_plan, with the clusters the card holds at
    once; at the main path's shapes (T=2560, B=256; T=13,108, B=24) every
    cluster must be resident."""
    from flappie_tpu_torch.ops import crf_bm_cuda, crf_cuda, cuda_build

    for name, info_fn, plan_fn, src, kernel in (
            ("K6", crf_bm_cuda.traceback_info, crf_bm_cuda._tb_plan, "crf_scan", "BmTrace"),
            ("K11 traceback", crf_cuda.traceback_bt_info, crf_cuda._tb_bt_plan, "crf_bt",
             "BtTrace")):
        for S in (8, 10, 4):
            got = []
            for T, B in TB_PLAN_SHAPES:
                info = info_fn(T, S, B)
                want = plan_fn(T, S, B)
                if tuple(info.values())[:6] != want:
                    raise AssertionError(f"{name} plan at T={T}, S={S}, B={B}: C side {info}, "
                                         f"Python {want}")
                clusters = info["ctas"] // info["C"]
                if (T, B) in ((2560, 256), (13_108, 24)) and info["max_active_clusters"] < clusters:
                    raise AssertionError(f"{name} at T={T}, S={S}, B={B}: {clusters} clusters, "
                                         f"the card holds {info['max_active_clusters']} at once")
                got.append(f"T={T}, B={B}: L={info['L']} x {info['rounds']} rounds, "
                           f"{clusters} clusters of {info['C']} CTAs of {info['W']} warps, "
                           f"{info['smem']} B a CTA, {info['max_active_clusters']} clusters "
                           f"resident at most")
            log(f"{name} S={S}: " + "; ".join(got))
        log(f"  {name} ptxas: " + ptxas_usage(cuda_build.build_log.get(src, ""), kernel))


def time_traceback(torch, fn, plain, ref, what: str, T: int) -> tuple:
    """A traceback wrapper's output bit-equal to its plain walk's (``ref``
    when given), then timed: the kernel behind a device sleep (its time is
    microseconds, the wrapper's host work tens of them), SCAN_REPS runs;
    the plain walk once.  Returns (ms, plain ms)."""
    got = fn()
    if not torch.equal(got, plain() if ref is None else ref):
        raise AssertionError(f"{what}: not bit-equal to its plain walk")
    ms = cuda_ms(torch, fn, SCAN_REPS, lead=True)
    plain_ms = cuda_ms(torch, plain, 1)
    log(f"{what}: {ms:.4f} ms (median of {SCAN_REPS}, behind a device sleep) = "
        f"{1e6 * ms / T:.2f} ns a step; plain walk {plain_ms:.1f} ms; bit-equal")
    return ms, plain_ms


def time_traceback_floor(torch) -> None:
    """Both tracebacks at one step on the grid of T=2560, B=256, S=8 (256
    CTAs in clusters of 4): the floor under their times (the launch, the
    cluster barriers, the exchange), beside one torch elementwise kernel
    timed the same way."""
    from flappie_tpu_torch.ops import crf_bm_cuda, crf_cuda

    dev = torch.device("cuda")
    B, S = 256, 8
    bp = torch.zeros(1, S, B, dtype=torch.int32, device=dev)
    valid = torch.ones(1, B, dtype=torch.int32, device=dev)
    last = torch.zeros(B, dtype=torch.int32, device=dev)
    bp_rev = bp.permute(0, 2, 1).to(torch.int8).contiguous()
    x = torch.zeros(B, device=dev)
    got = {name: cuda_ms(torch, fn, SCAN_REPS, lead=True) for name, fn in (
        ("K6", lambda: crf_bm_cuda.traceback(bp, valid, last)),
        ("K11 traceback", lambda: crf_cuda.traceback_bt(bp_rev, valid, last)),
        ("torch add_", lambda: x.add_(1)))}
    log(f"tracebacks at T=1, B={B}, S={S}, behind a device sleep (median of {SCAN_REPS}): "
        + "; ".join(f"{k} {ms:.4f} ms" for k, ms in got.items()))


def check_scans(torch, peak: dict, gen, nbase: int, libs: dict) -> list:
    """K3/K4, K9, K5, K6 on one dense batch, T=2560, B=256, S=2*nbase."""
    from flappie_tpu_torch.ops.crf import flipflop_index
    from flappie_tpu_torch.ops.crf_bm import _dense_tm

    dev = torch.device("cuda")
    T, B = 2560, 256
    S = 2 * nbase
    run, sfx = ("r941_native", "") if nbase == 4 else ("r941_5mC", f"_s{S}")
    idx = flipflop_index(nbase)
    trans = torch.randn(T, idx.nparam, B, generator=gen, device=dev) * 2.0
    nblocks = torch.randint(1, T, (B,), generator=gen, device=dev)
    nblocks[0], nblocks[1] = T, 0
    tvalid = torch.arange(T, device=dev)[:, None] < nblocks[None, :]
    return check_chain_scans(torch, peak, libs, _dense_tm(trans, idx), tvalid, idx, run, sfx,
                             "r941_native_fused" if nbase == 4 else None)


def check_chain_scans(torch, peak: dict, libs: dict, dense, tvalid, idx, run: str, sfx: str,
                      fused_run: str = None) -> list:
    """K3/K4, K9 (where compiled: S = 8 and 10), K5 and K6 on batch-minor
    dense blocks [T, S, S, B] of the chain ``idx``: each held to its plain
    version and timed, K3 also in the builds of 1, 2 and 4 chain warps a
    CTA.  Rows named with ``sfx``, their launches read from ``run``'s
    counts (K9's from ``fused_run``'s, when given)."""
    from flappie_tpu_torch.ops import crf_bm_cuda

    T, S, _, B = dense.shape
    rows = []
    nv = int(tvalid.sum().item())
    dense_bytes = 4 * T * S * S * B

    err = 0.0
    for backward in (True, False):
        got = crf_bm_cuda.sum_states(dense, tvalid, backward)
        want = crf_bm_cuda.sum_states_plain(dense, tvalid, backward)
        torch.cuda.synchronize()
        delta = (got - want).abs()
        if not bool((delta <= 1e-5 * want.abs() + 1e-5).all()):
            raise AssertionError(f"K3/K4 crf_sum_scan S={S} (backward={backward}): "
                                 "outside rtol 1e-5")
        err = max(err, delta.max().item())
    ms = cuda_ms(torch, lambda: crf_bm_cuda.sum_states(dense, tvalid, False), SCAN_REPS)
    plain_ms = cuda_ms(torch, lambda: crf_bm_cuda.sum_states_plain(dense, tvalid, False), 1)
    bms, by = bound(dense_bytes + 4 * T * B + 4 * (T + 1) * S * B, nv * (5 * S * S + 5 * S), peak)
    log(f"K3/K4 crf_sum_scan S={S}, T={T}, B={B}: {scan_step(ms, T, S, B)}")
    time_scan_warps(torch, libs, dense, tvalid, got, f"S={S}, T={T}, B={B}")
    rows.append(row("crf_sum_scan" + sfx, "K3/K4", "crf_scan.cu", "crf_bm_pallas.py:69", run,
                    "crf_sum_scan", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=None))

    if S in crf_bm_cuda.FWDBWD_STATES:
        rows += check_fwdbwd(torch, peak, dense, tvalid, fused_run)
    rows += check_viterbi_traceback(torch, peak, dense, tvalid, idx, run, sfx)
    return rows


def check_fwdbwd(torch, peak: dict, dense, tvalid, fused_run: str = None) -> list:
    """K9: both chains in one launch, within rtol 1e-5 of its plain
    version and bit-equal to K3's and K4's outputs; a row when
    ``fused_run`` names the run whose counts give its launches."""
    from flappie_tpu_torch.ops import crf_bm_cuda

    T, S, _, B = dense.shape
    nv = int(tvalid.sum().item())
    dense_bytes = 4 * T * S * S * B
    got = crf_bm_cuda.fwdbwd_states(dense, tvalid)
    want = crf_bm_cuda.fwdbwd_states_plain(dense, tvalid)
    split = [crf_bm_cuda.sum_states(dense, tvalid, backward) for backward in (False, True)]
    torch.cuda.synchronize()
    err = 0.0
    for g, w, k in zip(got, want, split):
        delta = (g - w).abs()
        if not bool((delta <= 1e-5 * w.abs() + 1e-5).all()):
            raise AssertionError(f"K9 crf_fwdbwd S={S}: outside rtol 1e-5 of its plain version")
        if not torch.equal(g, k):
            raise AssertionError(f"K9 crf_fwdbwd S={S}: not bit-equal to K3/K4")
        err = max(err, delta.max().item())
    ms = cuda_ms(torch, lambda: crf_bm_cuda.fwdbwd_states(dense, tvalid), SCAN_REPS)
    split_ms = cuda_ms(torch, lambda: [crf_bm_cuda.sum_states(dense, tvalid, bw)
                                       for bw in (False, True)], SCAN_REPS)
    plain_ms = cuda_ms(torch, lambda: crf_bm_cuda.fwdbwd_states_plain(dense, tvalid), 1)
    bms, by = bound(dense_bytes + 4 * T * B + 8 * (T + 1) * S * B,
                    2 * nv * (5 * S * S + 5 * S), peak)
    log(f"K9 crf_fwdbwd S={S}: {scan_step(ms, T, S, B, chains=2)}, against K3 + K4 split "
        f"{split_ms:.3f} ms, bit-equal to them; max |kernel - plain| {err:.2e}")
    if fused_run is None:
        return []
    return [row("crf_fwdbwd", "K9", "crf_scan.cu", "crf_bm_pallas.py:95", fused_run,
                "crf_fwdbwd", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)]


def check_viterbi_traceback(torch, peak: dict, dense, tvalid, idx, run: str, sfx: str) -> list:
    """K5 and K6 on batch-minor dense blocks: bit-equal to their plain
    versions (K6 also to its segmented twin), timed (K6 behind a device
    sleep)."""
    from flappie_tpu_torch.ops import crf_bm_cuda

    T, S, _, B = dense.shape
    nv = int(tvalid.sum().item())
    dense_bytes = 4 * T * S * S * B
    rows = []
    alpha, bps = crf_bm_cuda.viterbi_fwd(dense, tvalid, idx.tie_rank)
    alpha0, bps0 = crf_bm_cuda.viterbi_fwd_plain(dense, tvalid, idx.tie_rank)
    if not (torch.equal(alpha, alpha0) and torch.equal(bps, bps0)):
        raise AssertionError(f"K5 crf_viterbi S={S}: not bit-equal to its plain version")
    ms = cuda_ms(torch, lambda: crf_bm_cuda.viterbi_fwd(dense, tvalid, idx.tie_rank), SCAN_REPS)
    plain_ms = cuda_ms(torch, lambda: crf_bm_cuda.viterbi_fwd_plain(dense, tvalid, idx.tie_rank), 1)
    bms, by = bound(dense_bytes + 4 * T * B + 4 * S * S + 4 * T * S * B + 4 * S * B,
                    nv * (4 * S * S + 3 * S), peak)
    log(f"K5 crf_viterbi S={S}, T={T}, B={B}: {scan_step(ms, T, S, B)}")
    rows.append(row("crf_viterbi" + sfx, "K5", "crf_scan.cu", "crf_bm_pallas.py:135", run,
                    "crf_viterbi", max_abs_err=(alpha - alpha0).abs().max().item(), ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None))

    last = alpha.argmax(dim=0).to(torch.int32)
    path = crf_bm_cuda.traceback(bps, tvalid, last)
    path0 = crf_bm_cuda.traceback_plain(bps, tvalid, last)
    if not (torch.equal(path, path0)
            and torch.equal(path, crf_bm_cuda.traceback_segmented_plain(bps, tvalid, last))):
        raise AssertionError(f"K6 crf_traceback S={S}: not equal to its plain walk and twin")
    vi = tvalid.to(torch.int32)  # the kernel's valid type: no conversion in the timed call
    ms, plain_ms = time_traceback(
        torch, lambda: crf_bm_cuda.traceback(bps, vi, last),
        lambda: crf_bm_cuda.traceback_plain(bps, tvalid, last), path0,
        f"K6 crf_traceback S={S}, T={T}, B={B}", T)
    bms, by = bound(4 * T * S * B + 4 * T * B + 4 * B + 4 * (T + 1) * B, nv * S, peak)
    rows.append(row("crf_traceback" + sfx, "K6", "crf_scan.cu", "crf_bm_pallas.py:170", run,
                    "crf_traceback", max_abs_err=float((path - path0).abs().max().item()),
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None))
    return rows


def check_bt_scans(torch, peak: dict, gen, libs: dict, kind: str, nbase: int = 4) -> list:
    """K11 on one batch-major dense batch, T=2560, B=256, ragged nblocks:
    the run-length structure (S=8, runnie's main path; rows) or the
    flip-flop one of ``nbase`` bases (S=8, r941_native's path under
    pallas; S=10; checked and logged, no row).  The forward and Viterbi
    scans timed over SCAN_REPS runs with their time a step, grid and
    registers; at S=8 (run-length) and S=10 also in K11's other builds; at
    S=8 the backward pass's input profiled."""
    from flappie_tpu_torch.ops.crf import dense_from_params, flipflop_index, rle_index

    dev = torch.device("cuda")
    T, B = 2560, 256
    idx = rle_index(nbase) if kind == "rle" else flipflop_index(nbase)
    S = idx.nstate
    trans = torch.randn(T, B, idx.nparam, generator=gen, device=dev) * 2.0
    nblocks = torch.randint(1, T, (B,), generator=gen, device=dev)
    nblocks[0], nblocks[1] = T, 0
    valid = torch.arange(T, device=dev)[:, None] < nblocks[None, :]
    tag = f"K11 {kind} S={S}"
    rows = check_bt_chain(torch, peak, libs, dense_from_params(trans, idx), valid, idx, tag,
                          "rle_r941_native_pallas", "", builds=kind == "rle" or S == 10,
                          profile=kind == "rle")
    if kind == "rle":
        return rows
    for r in rows:
        log(f"{tag} {r['name']}: {r['ms']:.3f} ms, plain {r['plain_ms']:.1f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max |kernel - plain| "
            f"{r['max_abs_err']:.2e}")
    return []


def check_bt_chain(torch, peak: dict, libs: dict, dense, valid, idx, tag: str, run: str,
                   sfx: str, builds: bool, profile: bool) -> list:
    """K11's forward scan (within rtol 1e-5), Viterbi scan and traceback
    (bit-equal) on batch-major dense blocks [T, B, S, S] of the chain
    ``idx``, each timed; ``builds``: the scans also in K11's other builds,
    ``profile``: the backward pass's input profiled.  Rows named with
    ``sfx``, their launches read from ``run``'s counts."""
    from flappie_tpu_torch.ops import crf_cuda

    T, B, S, _ = dense.shape
    nv = int(valid.sum().item())
    dense_bytes = 4 * T * B * S * S
    rows = []

    got = crf_cuda.fwd_scan(dense, valid)
    want = crf_cuda.fwd_scan_plain(dense, valid)
    torch.cuda.synchronize()
    delta = (got - want).abs()
    if not bool((delta <= 1e-5 * want.abs() + 1e-5).all()):
        raise AssertionError(f"{tag} crf_bt_fwd: outside rtol 1e-5 of its plain version")
    ms = cuda_ms(torch, lambda: crf_cuda.fwd_scan(dense, valid), SCAN_REPS)
    log(f"{tag} crf_bt_fwd, T={T}, B={B}: {bt_step(ms, T, S, B, 'crf_bt_fwd_kernel')}")
    plain_ms = cuda_ms(torch, lambda: crf_cuda.fwd_scan_plain(dense, valid), 1)
    bms, by = bound(dense_bytes + 4 * T * B + 4 * T * B * S, nv * (5 * S * S + 5 * S), peak)
    rows.append(row("crf_bt_fwd" + sfx, "K11", "crf_bt.cu", "crf_pallas.py:45", run, "crf_bt_fwd",
                    max_abs_err=delta.max().item(), ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=None))

    alphas, bps = crf_cuda.viterbi_scan(dense, valid, idx.tie_rank)
    alphas0, bps0 = crf_cuda.viterbi_scan_plain(dense, valid, idx.tie_rank)
    if not (torch.equal(alphas, alphas0) and torch.equal(bps, bps0)):
        raise AssertionError(f"{tag} crf_bt_viterbi: not bit-equal to its plain version")
    ms = cuda_ms(torch, lambda: crf_cuda.viterbi_scan(dense, valid, idx.tie_rank), SCAN_REPS)
    log(f"{tag} crf_bt_viterbi, T={T}, B={B}: {bt_step(ms, T, S, B, 'crf_bt_viterbi_kernel')}")
    plain_ms = cuda_ms(torch, lambda: crf_cuda.viterbi_scan_plain(dense, valid, idx.tie_rank), 1)
    bms, by = bound(dense_bytes + 4 * T * B + 4 * S * S + 5 * T * B * S, nv * (4 * S * S + 3 * S),
                    peak)
    rows.append(row("crf_bt_viterbi" + sfx, "K11", "crf_bt.cu", "crf_pallas.py:73", run,
                    "crf_bt_viterbi", max_abs_err=(alphas - alphas0).abs().max().item(), ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None))

    if builds:
        time_bt_builds(torch, libs, dense, valid, idx.tie_rank, got, (alphas, bps),
                       f"S={S}, T={T}, B={B}")
    if profile:
        profile_bwd_copy(torch, dense, valid, f"S={S}, T={T}, B={B}")

    last = alphas[-1].argmax(dim=-1).to(torch.int32)
    bp_rev, valid_rev = bps.flip(0).contiguous(), valid.flip(0)
    states = crf_cuda.traceback_bt(bp_rev, valid_rev, last)
    states0 = crf_cuda.traceback_bt_plain(bp_rev, valid_rev, last)
    if not (torch.equal(states, states0) and torch.equal(
            states, crf_cuda.traceback_bt_segmented_plain(bp_rev, valid_rev, last))):
        raise AssertionError(f"{tag} crf_bt_traceback: not equal to its plain walk and twin")
    vri = valid_rev.to(torch.int32).contiguous()
    ms, plain_ms = time_traceback(
        torch, lambda: crf_cuda.traceback_bt(bp_rev, vri, last),
        lambda: crf_cuda.traceback_bt_plain(bp_rev, valid_rev, last), states0,
        f"{tag} crf_bt_traceback, T={T}, B={B}", T)
    bms, by = bound(T * B * S + 4 * T * B + 4 * B + 4 * T * B, nv * S, peak)
    rows.append(row("crf_bt_traceback" + sfx, "K11", "crf_bt.cu", "crf_pallas.py:115", run,
                    "crf_bt_traceback", max_abs_err=float((states - states0).abs().max().item()),
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None))
    return rows


# runnie's heaviest program: bucket 65536 samples = 13,108 blocks, its 24
# reads (RUNNIE_READS) filling part of the scans' last 32-read block
RUNNIE_SCAN_SHAPE = (13_108, 24)


def check_runnie_scans(torch, peak: dict, gen, libs: dict) -> None:
    """Every CRF kernel of runnie's main path against its plain version at
    the shape of its heaviest program (RUNNIE_SCAN_SHAPE), the run-length
    structure, ragged nblocks including 0 and T: K3/K4, K9 (bit-equal to
    them), K5, K6 (default impl) and K11's three (pallas), K11's forward
    scan also over the transposed, time-reversed blocks of the backward
    pass.  Tolerances as at T=2560; checked and logged with the times of
    K3, K9, K5, K6 and K11's three (and K3's, K11's other builds), and
    K11's backward-pass input profiled; no row."""
    from flappie_tpu_torch.ops import crf_bm_cuda, crf_cuda
    from flappie_tpu_torch.ops.crf import dense_from_params, rle_index
    from flappie_tpu_torch.ops.crf_bm import _dense_tm

    dev = torch.device("cuda")
    T, B = RUNNIE_SCAN_SHAPE
    idx = rle_index(4)
    trans = torch.randn(T, B, idx.nparam, generator=gen, device=dev) * 2.0
    # the bucket's reads have more than half its blocks
    nblocks = torch.randint(T // 2, T, (B,), generator=gen, device=dev)
    nblocks[0], nblocks[1] = T, 0
    valid = torch.arange(T, device=dev)[:, None] < nblocks[None, :]
    tag = f"runnie scans at T={T}, B={B}, S={idx.nstate}"
    errs = {}

    def close(name, got, want):
        torch.cuda.synchronize()
        delta = (got - want).abs()
        if not bool((delta <= 1e-5 * want.abs() + 1e-5).all()):
            raise AssertionError(f"{tag}: {name} outside rtol 1e-5 of its plain version")
        errs[name] = delta.max().item()

    def equal(name, got, want):
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{tag}: {name} not bit-equal to its plain version")
        errs[name] = 0.0

    dense = _dense_tm(trans.permute(0, 2, 1), idx)  # [T, S, S, B]
    split = [crf_bm_cuda.sum_states(dense, valid, backward) for backward in (False, True)]
    for backward in (False, True):
        close(f"K3/K4 (backward={backward})", split[backward],
              crf_bm_cuda.sum_states_plain(dense, valid, backward))
    equal("K9 against K3/K4", crf_bm_cuda.fwdbwd_states(dense, valid), split)
    alpha, bps = crf_bm_cuda.viterbi_fwd(dense, valid, idx.tie_rank)
    equal("K5", (alpha, bps), crf_bm_cuda.viterbi_fwd_plain(dense, valid, idx.tie_rank))
    S = idx.nstate
    for name, fn, chains in (
            ("K3", lambda: crf_bm_cuda.sum_states(dense, valid, False), 1),
            ("K9", lambda: crf_bm_cuda.fwdbwd_states(dense, valid), 2),
            ("K5", lambda: crf_bm_cuda.viterbi_fwd(dense, valid, idx.tie_rank), 1)):
        log(f"{tag}: {name} {scan_step(cuda_ms(torch, fn, SCAN_REPS), T, S, B, chains)}")
    time_scan_warps(torch, libs, dense, valid, split[0], f"T={T}, B={B}, S={S}")
    last = alpha.argmax(dim=0).to(torch.int32)
    equal("K6", (crf_bm_cuda.traceback(bps, valid, last),),
          (crf_bm_cuda.traceback_plain(bps, valid, last),))
    nv = int(valid.sum().item())
    vi = valid.to(torch.int32)
    ms, _ = time_traceback(torch, lambda: crf_bm_cuda.traceback(bps, vi, last),
                           lambda: crf_bm_cuda.traceback_plain(bps, valid, last), None,
                           f"{tag}: K6", T)
    bms, by = bound(4 * T * B * (S + 2) + 8 * B, nv * S, peak)
    log(f"{tag}: K6 bound {bms:.4f} ms ({by}), {ms / bms:.1f}x it")

    dense = dense_from_params(trans, idx)  # [T, B, S, S]
    fwd = crf_cuda.fwd_scan(dense, valid)
    close("K11 forward", fwd, crf_cuda.fwd_scan_plain(dense, valid))
    rev = dense.flip(0).transpose(-1, -2)
    close("K11 forward (backward pass)", crf_cuda.fwd_scan(rev, valid.flip(0)),
          crf_cuda.fwd_scan_plain(rev, valid.flip(0)))
    alphas, bps = crf_cuda.viterbi_scan(dense, valid, idx.tie_rank)
    equal("K11 Viterbi", (alphas, bps), crf_cuda.viterbi_scan_plain(dense, valid, idx.tie_rank))
    for name, kernel, fn, bytes_, ops in (
            ("K11 forward", "crf_bt_fwd_kernel", lambda: crf_cuda.fwd_scan(dense, valid),
             4 * T * B * (S * S + 1 + S), nv * (5 * S * S + 5 * S)),
            ("K11 Viterbi", "crf_bt_viterbi_kernel",
             lambda: crf_cuda.viterbi_scan(dense, valid, idx.tie_rank),
             4 * T * B * (S * S + 1) + 4 * S * S + 5 * T * B * S, nv * (4 * S * S + 3 * S))):
        bms, by = bound(bytes_, ops, peak)
        log(f"{tag}: {name} {bt_step(cuda_ms(torch, fn, SCAN_REPS), T, S, B, kernel)}; bound "
            f"{bms:.4f} ms ({by})")
    time_bt_builds(torch, libs, dense, valid, idx.tie_rank, fwd, (alphas, bps),
                   f"T={T}, B={B}, S={S}")
    profile_bwd_copy(torch, dense, valid, f"T={T}, B={B}, S={S}")
    last = alphas[-1].argmax(dim=-1).to(torch.int32)
    bp_rev, valid_rev = bps.flip(0).contiguous(), valid.flip(0)
    equal("K11 traceback", (crf_cuda.traceback_bt(bp_rev, valid_rev, last),),
          (crf_cuda.traceback_bt_plain(bp_rev, valid_rev, last),))
    vri = valid_rev.to(torch.int32).contiguous()
    ms, _ = time_traceback(torch, lambda: crf_cuda.traceback_bt(bp_rev, vri, last),
                           lambda: crf_cuda.traceback_bt_plain(bp_rev, valid_rev, last), None,
                           f"{tag}: K11 traceback", T)
    bms, by = bound(T * B * S + 8 * T * B + 4 * B, nv * S, peak)
    log(f"{tag}: K11 traceback bound {bms:.4f} ms ({by}), {ms / bms:.1f}x it")
    log(f"{tag}: every kernel within its tolerance of its plain version; max |kernel - plain| "
        + json.dumps(errs))


# K10's shapes (B reads, T samples) on its main paths: r941_native's chunk
# batch (5 launches a fb run under conv pallas), runnie's heaviest bucket
# and the training batch (one launch a step)
CONV12_SHAPES = ((256, 12800), (24, 65_536), (32, 2560))


def conv12_inputs(torch, gen, B: int, T: int, full: bool = False):
    """K10's arguments: x zero past each read's length, lengths ragged in
    [1, T) with 0, 3 and T among them (``full``: every read T long)."""
    dev = torch.device("cuda")
    lengths = torch.randint(1, T, (B,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1], lengths[2] = T, 0, 3
    if full:
        lengths.fill_(T)
    m = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    x = torch.randn(B, T, generator=gen, device=dev) * m
    W1 = torch.randn(5, 1, 4, generator=gen, device=dev) * 0.5
    b1 = torch.randn(4, generator=gen, device=dev) * 0.1
    W2 = torch.randn(5, 4, 16, generator=gen, device=dev) * 0.3
    b2 = torch.randn(16, generator=gen, device=dev) * 0.1
    return x, W1, b1, W2, b2, lengths


def check_conv12(torch, peak: dict, gen, libs: dict) -> dict:
    """K10 at each of CONV12_SHAPES (ragged lengths including 0, 3 and T,
    and once more with every read full: a tile wholly past a read's end
    writes zeros without computing), within 1e-5 of its plain version and
    zero past every length, timed behind a device sleep with its bound
    fraction, the plan (flappie_conv12_info held to ops/conv_cuda.py's
    _conv12_plan) and ptxas's registers; at the chunk batch, under both
    lengths, also the builds of VARIANTS' conv12_* (one CTA an item,
    direct stores instead of the bulk copies, every swish through the
    precise division's branch), each bit-equal to the path's, alternated,
    and the path's once more with every length 0 (the stores alone).
    The library call (at the chunk batch, ragged) is the same two layers as
    two cuDNN F.conv1d calls on [B, C, T] with swish and the masks between
    them (TF32 off, as the port sets it).  Returns the chunk batch's row,
    timed on ragged lengths."""
    import torch.nn.functional as F

    from flappie_tpu_torch.ops import conv_cuda, cuda_build

    log("K10 ptxas (G = 4, 1 channel groups): "
        f"{ptxas_usage(cuda_build.build_log.get('conv12', ''), 'conv12_kernel')}; " + "; ".join(
            f"build {k}: {ptxas_usage(variant_log[k], 'conv12_kernel')}"
            for k in libs if k.startswith("conv12_")))
    variants = {"path": None, **{k[len("conv12_"):]: lib for k, lib in libs.items()
                                 if k.startswith("conv12_")}}
    numbers = {}
    for B, T in CONV12_SHAPES:
        info = conv_cuda.conv12_info(B, T)
        per_sm = {1: info["per_sm_g1"], 4: info["per_sm_g4"]}
        want_plan = conv_cuda._conv12_plan(B, T, per_sm, info["sms"])
        if tuple(info[k] for k in conv_cuda.INFO[:6]) + (info["smem"],) != want_plan:
            raise AssertionError(f"K10 plan at B={B}, T={T}: C {info}, Python {want_plan}")
        what = f"K10 at B={B}, T={T}"
        # x read and y2 written once; 2 x (5 x 4 + 5 x 4 x 16) f32 operations
        # a sample (the FMAs of both convs)
        bms, by = bound(4 * (B * T * 17 + 360 + B), 680 * B * T, peak)
        times = {}
        for full in (False, True):
            lens = "every read full" if full else "ragged lengths"
            args = conv12_inputs(torch, gen, B, T, full)
            got = conv_cuda.conv12_fused(*args)
            want = conv_cuda.conv12_fused_plain(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not err <= 1e-5:
                raise AssertionError(f"{what}, {lens}: max |kernel - plain| {err} > 1e-5")
            past = torch.arange(T, device=got.device)[None, None, :] >= args[5][:, None, None]
            if torch.where(past, got, 0.0).any():
                raise AssertionError(f"{what}, {lens}: output not zero past a read's length")
            del want, past
            times[lens] = cuda_ms(torch, lambda: conv_cuda.conv12_fused(*args), 10, lead=True)
            if (B, T) != CONV12_SHAPES[0]:
                continue
            time_builds(torch, "conv12", variants, lambda: conv_cuda.conv12_fused(*args), got,
                        f"{what}, {lens}, by build (behind a device sleep)", B * T, lead=True,
                        unit="sample")
            if not full:
                numbers = dict(max_abs_err=err, ms=times[lens], bound_ms=bms, bound_by=by,
                               plain_ms=cuda_ms(torch, lambda: conv_cuda.conv12_fused_plain(
                                   *args), 3))
                x, b1, b2 = args[0], args[2], args[4]
                m3 = (torch.arange(T, device=x.device)[None, :] < args[5][:, None])[:, None, :]
                w1c, w2c = args[1].permute(2, 1, 0), args[3].permute(2, 1, 0)

                def library():
                    y1 = torch.where(m3, F.silu(F.conv1d(x[:, None, :], w1c, b1, padding=2)), 0.0)
                    return torch.where(m3, F.silu(F.conv1d(y1, w2c, b2, padding=2)), 0.0)

                lib_err = (library() - got).abs().max().item()
                numbers["library_ms"] = cuda_ms(torch, library, 10)
                log(f"K10 library call computes the same function: max |cuDNN - kernel| "
                    f"{lib_err:.2e}")
                # every length 0: no arithmetic, only the zero rows' bulk copies
                zargs = (*args[:5], torch.zeros_like(args[5]))
                if conv_cuda.conv12_fused(*zargs).any():
                    raise AssertionError(f"{what}, every length 0: output not zero")
                times["every length 0 (stores only)"] = cuda_ms(
                    torch, lambda: conv_cuda.conv12_fused(*zargs), 10, lead=True)
        log(f"{what}: within 1e-5 of its plain version, zero past every length; " + "; ".join(
            f"{k} {ms:.4f} ms = {bms / ms:.1%} of the bound" for k, ms in times.items())
            + f" (medians of 10 behind a device sleep); bound {bms:.4f} ms ({by}); "
            f"plan {json.dumps(info)}")
    return row("conv12", "K10", "conv12.cu", "conv_pallas.py:51", "r941_native_conv_pallas",
               "conv12", **numbers)


# kind -> (wrapper name in ops/rnn_cuda.py less "_cuda" = plain name in
# ops/rnn.py, gates, source, TPU kernel, the scan run supplying its count)
SEQ_KERNELS = {
    "lstm": ("lstm_seq", 4, "lstm.cu", "rnn_pallas.py:37", "r941_native_scan"),
    "grumod": ("grumod_seq", 3, "grumod.cu", "rnn_pallas.py:69", "r941_5mC_scan"),
}


def check_seq(torch, peak: dict, gen, kind: str) -> dict:
    """K12 (the recurrence alone over a computed affine, batch-major) at
    T=2560, B=256, H=256, all steps valid, within 1e-4 of ops/rnn.py's
    lstm_seq / grumod_seq.  The library call is one cuDNN nn.LSTM / nn.GRU
    with weight_ih the identity (GRU gates reordered): the same function
    plus one extra [B*T, G] x [G, G] product."""
    from flappie_tpu_torch.ops import rnn as t_rnn
    from flappie_tpu_torch.ops import rnn_cuda

    dev = torch.device("cuda")
    name, gates, source, replaces, run = SEQ_KERNELS[kind]
    fn, plain = getattr(rnn_cuda, name + "_cuda"), getattr(t_rnn, name)
    T, B, H = 2560, 256, 256
    G = gates * H
    xa = torch.randn(B, T, G, generator=gen, device=dev) * 0.5
    if gates == 4:
        xa[..., H : 2 * H] += 0.75  # a forget bias
    else:
        xa[..., 2 * H :] += 0.75  # the candidate term far from zero
    sW = torch.randn(H, G, generator=gen, device=dev) / H ** 0.5
    got = fn(xa, sW)
    want = plain(xa, sW)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not err <= 1e-4:
        raise AssertionError(f"K12 {name}: max |kernel - plain| {err} > 1e-4")
    ms = cuda_ms(torch, lambda: fn(xa, sW), 3)
    plain_ms = cuda_ms(torch, lambda: plain(xa, sW), 1)
    eye = torch.eye(G, device=dev)
    if gates == 4:
        ref = torch.nn.LSTM(G, H, batch_first=True).to(dev)
        w_ih, w_hh = eye, sW.T
    else:
        ref = torch.nn.GRU(G, H, batch_first=True).to(dev)
        w_ih, w_hh = cudnn_gru_order(eye, H), cudnn_gru_order(sW.T, H)
    with torch.no_grad():
        ref.weight_ih_l0.copy_(w_ih)
        ref.weight_hh_l0.copy_(w_hh)
        ref.bias_ih_l0.zero_()
        ref.bias_hh_l0.zero_()
        lib_err = (ref(xa)[0] - got).abs().max().item()
        library_ms = cuda_ms(torch, lambda: ref(xa), 3)
    log(f"K12 {name} library call (cuDNN, weight_ih = identity: one extra {B * T} x {G} x {G} "
        f"product) computes the same function: max |cuDNN - kernel| {lib_err:.2e}")
    bms, by = bound(4 * (B * T * G + H * G + B * T * H), 2 * T * B * H * G, peak)
    return row(name, "K12", source, replaces, run, name, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)


def bf16_ulps(torch, got, want):
    """Elementwise distance of two bf16 tensors in bf16 ulps: the bit
    patterns on an ordered integer line (+0 and -0 both 0)."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(got) - ordered(want)).abs()


def affine_agreement(torch, got, want, x, iW, what: str) -> dict:
    """The bf16 affine ``got`` against its plain version ``want`` (f32
    product, one rounding): every element within one bf16 ulp, except
    where the f32 sum cancels to below what summing its K products in
    another order can move it (K 2^-23 sum_k |x_k w_k|), where one bf16
    ulp of the near-zero result is finer than that; raises outside.
    Returns the counts."""
    ulps = bf16_ulps(torch, got, want)
    delta = (got.float() - want.float()).abs()
    noise = (x.float().abs() @ iW.float().abs()) * (x.shape[1] * 2.0 ** -23)
    over = ulps > 1
    bad = int((over & (delta > noise)).sum().item())
    stats = {"elements": ulps.numel(), "differ": int((ulps > 0).sum().item()),
             "over_one_ulp": int(over.sum().item()),
             "max_abs_err": delta.max().item(),
             "largest_over_one_ulp": (want.float().abs()[over].max().item()
                                      if over.any() else 0.0),
             "max_noise": noise.max().item()}
    if bad:
        raise AssertionError(f"{what}: {bad} elements more than one bf16 ulp from the plain "
                             f"version and outside the f32 reassociation error ({stats})")
    return stats


# M = T x B of a chunk batch's layer, IN
AFFINE_SHAPE = (2560 * 256, 256)


def path_launches(rnn_cuda) -> tuple:
    """(wgmma, wmma) launch counts of the bf16 affine."""
    return rnn_cuda.affine_bf16.launches, rnn_cuda.affine_bf16_wmma.launches


def check_affine_bf16(torch, peak: dict, gen) -> dict:
    """The bf16 affine alone (csrc/affine.cuh) at M = 655,360, IN=256,
    G=1024 (LSTM) and G=768 (GRU-mod), and at runnie's M (13,108 x 24),
    G=1024, on the wgmma path: held to its plain version (affine_agreement,
    TF32 off), timed over 10 runs alternated with one library call,
    torch.addmm in bf16 (cuBLAS; its bias rounded to bf16 first); logged
    with its bound and ptxas's registers and spills of both paths; the
    wmma path at (300, 12, 40) held by the same rule.  Each
    launch lands on its path's counter.  Returns the G=1024 row."""
    from flappie_tpu_torch.ops import cuda_build, rnn_cuda

    dev = torch.device("cuda")
    K = AFFINE_SHAPE[1]
    out = None
    for M, G in ((AFFINE_SHAPE[0], 1024), (AFFINE_SHAPE[0], 768), (13_108 * 24, 1024)):
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        iW = (torch.randn(K, G, generator=gen, device=dev) / K ** 0.5).to(torch.bfloat16)
        b = torch.randn(G, generator=gen, device=dev) * 0.2
        b16 = b.to(torch.bfloat16)
        before = path_launches(rnn_cuda)
        got = rnn_cuda.affine_bf16(x, iW, b)
        if path_launches(rnn_cuda) != (before[0] + 1, before[1]):
            raise AssertionError(f"affine_bf16 at M={M}, G={G} did not take the wgmma path")
        want = rnn_cuda.affine_bf16_plain(x, iW, b)
        stats = affine_agreement(torch, got, want, x, iW, f"affine_bf16 at M={M}, G={G}")
        lib_err = (torch.addmm(b16, x, iW).float() - want.float()).abs().max().item()
        del got, want
        times = alternated_ms(torch, {"kernel": lambda: rnn_cuda.affine_bf16(x, iW, b),
                                      "addmm": lambda: torch.addmm(b16, x, iW)}, ALTERNATED_REPS)
        ms, library_ms = (statistics.median(times[k]) for k in ("kernel", "addmm"))
        plain_ms = cuda_ms(torch, lambda: rnn_cuda.affine_bf16_plain(x, iW, b), 1)
        bms, by = bound(2 * (M * K + K * G + M * G) + 4 * G, 0, peak, 2 * M * K * G)
        log(f"affine_bf16 at M={M}, IN={K}, G={G}: {stats['differ']} of {stats['elements']} "
            f"elements differ from the plain version, {stats['over_one_ulp']} by more than one "
            f"bf16 ulp (each inside the f32 reassociation error, at most "
            f"{stats['max_noise']:.2e}; the largest such |value| "
            f"{stats['largest_over_one_ulp']:.2e}), max |delta| {stats['max_abs_err']:.2e}; "
            f"kernel {spread(times['kernel'])}; torch.addmm bf16 {spread(times['addmm'])} "
            f"(max |addmm - plain| {lib_err:.2e}); kernel/addmm {ms / library_ms:.3f}; plain "
            f"{plain_ms:.3f} ms; bound {bms:.3f} ms ({by}) = {100 * bms / ms:.1f}% of the "
            f"kernel's time")
        if out is None:
            out = row("affine_bf16", "affine-bf16", "affine.cuh", "rnn_pallas.py:243",
                      "r941_native_fast", "affine_bf16", max_abs_err=stats["max_abs_err"],
                      ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                      library_ms=library_ms)
    M, K, G = WMMA_SHAPE
    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
    iW = (torch.randn(K, G, generator=gen, device=dev) / K ** 0.5).to(torch.bfloat16)
    b = torch.randn(G, generator=gen, device=dev) * 0.2
    before = path_launches(rnn_cuda)
    got = rnn_cuda.affine_bf16(x, iW, b)
    if path_launches(rnn_cuda) != (before[0], before[1] + 1):
        raise AssertionError(f"affine_bf16 at (M, K, N) = {WMMA_SHAPE} did not take the wmma path")
    stats = affine_agreement(torch, got, rnn_cuda.affine_bf16_plain(x, iW, b), x, iW,
                             f"affine_bf16 (wmma) at {WMMA_SHAPE}")
    log(f"affine_bf16's wmma path at (M, K, N) = {WMMA_SHAPE}: {stats['differ']} of "
        f"{stats['elements']} elements differ from the plain version, max |delta| "
        f"{stats['max_abs_err']:.2e}")
    text = cuda_build.build_log.get("lstm", "")
    log("affine_bf16 ptxas: wgmma " + ptxas_usage(text, "affine_bf16_kernel") + "; wmma "
        + ptxas_usage(text, "affine_bf16_wmma_kernel"))
    return out


# (M, K, N) of the bf16 affine off the TMA grid: the wmma path
WMMA_SHAPE = (300, 12, 40)


def check_affine_f32(torch, peak: dict, gen) -> dict:
    """The f32 affine alone (csrc/affine.cuh affine_kernel, the one inside
    K1, K7 and K8) at M = 655,360, IN=256, G=1024 and G=768, TF32 off:
    each element within f32 reassociation of its plain version,
    torch.matmul + b (K 2^-23 sum_k |x_k w_k| for the K products summed in
    another order, plus 2^-23 |value| for the bias added to another sum),
    timed over 10 runs alternated with torch.addmm in f32 (its library
    time); logged with its bound and ptxas's registers and spills.
    Returns the G=1024 row."""
    from flappie_tpu_torch.ops import cuda_build, rnn_cuda

    dev = torch.device("cuda")
    M, K = AFFINE_SHAPE
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = None
    try:
        x = torch.randn(M, K, generator=gen, device=dev)
        for G in (1024, 768):
            iW = torch.randn(K, G, generator=gen, device=dev) / K ** 0.5
            b = torch.randn(G, generator=gen, device=dev) * 0.2
            got = rnn_cuda.affine_f32(x, iW, b)
            want = rnn_cuda.affine_f32_plain(x, iW, b)
            delta = (got - want).abs()
            noise = (x.abs() @ iW.abs()) * (K * 2.0 ** -23) + want.abs() * 2.0 ** -23
            bad = int((delta > noise).sum().item())
            err, equal = delta.max().item(), int((delta == 0).sum().item())
            lib_err = (torch.addmm(b, x, iW) - want).abs().max().item()
            if bad:
                raise AssertionError(f"affine_f32 at G={G}: {bad} elements outside the f32 "
                                     f"reassociation error (max |delta| {err})")
            del got, want, delta, noise
            times = alternated_ms(torch, {"kernel": lambda: rnn_cuda.affine_f32(x, iW, b),
                                          "addmm": lambda: torch.addmm(b, x, iW)},
                                  ALTERNATED_REPS)
            ms, library_ms = (statistics.median(times[k]) for k in ("kernel", "addmm"))
            plain_ms = cuda_ms(torch, lambda: rnn_cuda.affine_f32_plain(x, iW, b), 1)
            bms, by = bound(4 * (M * K + K * G + G + M * G), 2 * M * K * G, peak)
            log(f"affine_f32 at M={M}, IN={K}, G={G} (TF32 off): {equal} of {M * G} elements "
                f"equal to the plain version's, max |delta| {err:.2e}, every one inside the f32 "
                f"reassociation error; kernel {spread(times['kernel'])}; torch.addmm f32 "
                f"{spread(times['addmm'])} (max |addmm - plain| {lib_err:.2e}); kernel/addmm "
                f"{ms / library_ms:.3f}; plain {plain_ms:.3f} ms; bound {bms:.3f} ms ({by}) = "
                f"{100 * bms / ms:.1f}% of the kernel's time")
            if out is None:
                out = row("affine_f32", "affine-f32", "affine.cuh", "rnn_pallas.py:244",
                          "r941_native", "affine_f32", max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log("affine_f32 ptxas: " + ptxas_usage(cuda_build.build_log.get("lstm", ""), "affine_kernel"))
    return out


# (M, K, N) at which both affines' plans are held to the Python mirror:
# the model shapes (chunk batch, runnie's heaviest program), the edges of
# the persistent grid and shapes off the TMA grid
AFFINE_PLAN_SHAPES = ((655_360, 256, 1024), (655_360, 256, 768), (314_592, 256, 1024),
                      (1, 256, 1024), (129, 32, 48), (37, 8, 64), (300, 12, 40),
                      (4096, 512, 1024), (128 * 40, 256, 8 * 256), (1000, 96, 1024))


def log_affine_plans() -> None:
    """Both affines' plans from the C side (flappie_affine_info) held to
    ops/rnn_cuda.py's _affine_plan for this card's SMs."""
    import torch

    from flappie_tpu_torch.ops import rnn_cuda

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for M, K, N in AFFINE_PLAN_SHAPES:
        for bf16 in (False, True):
            got = rnn_cuda.affine_info(M, N, K, bf16)
            want = rnn_cuda._affine_plan(M, N, K, bf16, sms)
            if got != want:
                raise AssertionError(f"affine plan at (M, K, N) = ({M}, {K}, {N}), bf16={bf16}: "
                                     f"C side {got}, _affine_plan {want}")
    names = ("path", "BM", "BN", "BK", "stages", "smem", "CTAs", "tiles")
    for M, K, N in AFFINE_PLAN_SHAPES[:3]:
        for bf16 in (False, True):
            log(f"affine plan ({'bf16' if bf16 else 'f32'}, M={M}, K={K}, N={N}, {sms} SMs): "
                + ", ".join(f"{k} {v}" for k, v in zip(names, rnn_cuda.affine_info(M, N, K, bf16))))


# kind -> (id, gates, wrapper, source, TPU kernel, run and counter that
# supply the launch count)
BF16_LAYERS = {
    "lstm": ("K1-bf16", 4, "lstm_layer_tm", "lstm.cu", "rnn_pallas.py:273", "r941_native_fast",
             "lstm_layer_bf16"),
    "grumod": ("K7-bf16", 3, "grumod_layer_tm", "grumod.cu", "rnn_pallas.py:290",
               "r941_5mC_fast", "grumod_layer_bf16"),
}


def layer_inputs(torch, gen, gates: int, T: int, B: int, IN: int, H: int):
    """(x [T, B, IN] f32 masked past ragged lengths that include 0 and T,
    iW, b, sW, lengths) of check_layer's kind (K7's candidate bias far
    from zero)."""
    dev = torch.device("cuda")
    G = gates * H
    lengths = torch.randint(1, T, (B,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = T, 0
    mask = (torch.arange(T, device=dev)[:, None] < lengths[None, :])[..., None]
    x = torch.randn(T, B, IN, generator=gen, device=dev) * mask
    iW = torch.randn(IN, G, generator=gen, device=dev) / IN ** 0.5
    sW = torch.randn(H, G, generator=gen, device=dev) / H ** 0.5
    b = torch.randn(G, generator=gen, device=dev) * 0.2
    if gates == 4:
        b[H : 2 * H] += 1.0
    else:
        b[2 * H :] += 0.75
    return x, iW, b, sW, lengths


def hold_layer_bf16(torch, kid: str, fn, plain, x, iW, b, sW, lengths) -> tuple:
    """The bf16 layer ``fn`` on x rounded to bf16, both directions: within
    1e-2 of its plain version (the share of bit-equal elements logged) and,
    against the f32 kernel on the same inputs, inside the JAX package's
    band for the stream (max |delta| <= 0.05, mean < 0.01;
    tests/test_ops.py:436-437).  Returns (the max |delta| to the plain
    version, the plain version's time in ms backward, its second run)."""
    xb = x.to(torch.bfloat16)
    err, same, n, bmax, bsum = 0.0, 0, 0, 0.0, 0.0
    for backward in (False, True):
        got = fn(xb, iW, b, sW, backward, lengths)
        want, plain_ms = event_ms(torch, lambda: plain(xb, iW, b, sW, backward, lengths))
        exact = fn(x, iW, b, sW, backward, lengths)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16 or exact.dtype != torch.float32:
            raise AssertionError(f"{kid}: output {got.dtype}, the f32 kernel's {exact.dtype}")
        d = (got.float() - want.float()).abs()
        e = (got.float() - exact).abs()
        err, bmax = max(err, d.max().item()), max(bmax, e.max().item())
        same += int((d == 0).sum().item())
        n += d.numel()
        bsum += e.mean().item() / 2
    log(f"{kid} at T={x.shape[0]}, B={x.shape[1]}: max |kernel - plain| {err:.3e}, "
        f"{100 * same / n:.3f}% of elements bit-equal; against the f32 kernel max {bmax:.3e}, "
        f"mean {bsum:.3e} (the JAX band: 0.05, 0.01)")
    if not (err <= 1e-2 and bmax <= 0.05 and bsum < 0.01):
        raise AssertionError(f"{kid}: outside its bands (plain {err}, f32 max {bmax}, mean {bsum})")
    return err, plain_ms


# K1-bf16's other shape: runnie's heaviest program
BF16_SHAPES = {"lstm": ((2560, 256), (13_108, 24)), "grumod": ((2560, 256),)}


def check_layer_bf16(torch, peak: dict, gen, kind: str) -> dict:
    """K1-bf16 (kind "lstm") or K7-bf16 ("grumod") at T=2560, B=256,
    IN=H=256 (K1-bf16 also at T=13,108, B=24): held by hold_layer_bf16,
    then timed over 10 runs alternated with the f32 kernel on the same
    inputs, with the bf16 affine alone and the f32 recurrence alone (K12
    over the f32 affine) for the split between affine and recurrence."""
    from flappie_tpu_torch.ops import rnn_cuda

    kid, gates, wrapper, source, replaces, run, counter = BF16_LAYERS[kind]
    fn, plain = getattr(rnn_cuda, wrapper), getattr(rnn_cuda, wrapper + "_plain")
    seq = getattr(rnn_cuda, f"{kind}_seq_cuda")
    IN = H = 256
    G = gates * H
    out = None
    for T, B in BF16_SHAPES[kind]:
        x, iW, b, sW, lengths = layer_inputs(torch, gen, gates, T, B, IN, H)
        err, plain_ms = hold_layer_bf16(torch, kid, fn, plain, x, iW, b, sW, lengths)
        xb, iW16 = x.to(torch.bfloat16), iW.to(torch.bfloat16)
        xa = (x.transpose(0, 1) @ iW + b).contiguous()  # [B, T, G]
        with torch.no_grad():
            times = alternated_ms(torch, {
                "bf16": lambda: fn(xb, iW16, b, sW, True, lengths),
                "f32": lambda: fn(x, iW, b, sW, True, lengths),
                "affine_bf16": lambda: rnn_cuda.affine_bf16(xb.view(T * B, IN), iW16, b),
                "recurrence_f32": lambda: seq(xa, sW)}, ALTERNATED_REPS)
        ms, f32_ms, aff_ms, rec_ms = (statistics.median(times[k]) for k in (
            "bf16", "f32", "affine_bf16", "recurrence_f32"))
        log(f"{kid} at T={T}, B={B}, IN=H={H}, alternated with the f32 kernel: bf16 "
            f"{spread(times['bf16'])} = {1e3 * ms / T:.3f} us a step; f32 "
            f"{spread(times['f32'])} = {1e3 * f32_ms / T:.3f} us a step; bf16/f32 "
            f"{ms / f32_ms:.3f}.  Split: the bf16 affine alone {aff_ms:.3f} ms, so its "
            f"recurrence {ms - aff_ms:.3f} ms; the f32 recurrence alone (K12) {rec_ms:.3f} ms, "
            f"so the f32 affine {f32_ms - rec_ms:.3f} ms")
        if (T, B) == (2560, 256):
            nvalid = int(lengths.sum().item())
            bms, by = bound(2 * (nvalid * IN + IN * G + T * B * H) + 4 * (G + H * G + B),
                            2 * nvalid * H * G, peak, 2 * nvalid * IN * G)
            out = row(kid, kid, source, replaces, run, counter, max_abs_err=err, ms=ms,
                      plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)
    return out


def cudnn_lstm(torch, iW, b, sW):
    """A cuDNN nn.LSTM holding K1's weights (gate order i, f, g, o is
    K1's u, f, g, o; bias_hh zero)."""
    IN, G = iW.shape
    ref = torch.nn.LSTM(IN, G // 4).to(iW.device)
    with torch.no_grad():
        ref.weight_ih_l0.copy_(iW.T)
        ref.weight_hh_l0.copy_(sW.T)
        ref.bias_ih_l0.copy_(b)
        ref.bias_hh_l0.zero_()
    return ref


def check_layer_train_bf16(torch, peak: dict, gen) -> dict:
    """K8-bf16 (K8 under the bf16 stream, the training forward under
    --fast's stream) at T=2560, B=256, IN=H=256, both directions, ragged
    lengths including 0 and T: h within 1e-2 and c within 1e-2 max(1, |c|)
    of the plain version (one bf16 ulp of an output, carried by the
    state, as K1-bf16's band), h bit-equal to K1-bf16's on the same
    inputs; timed over 10 runs alternated with K1-bf16 and with cuDNN's
    training-mode forward (inputs that require gradients), its library
    call."""
    from flappie_tpu_torch.ops import rnn_cuda

    IN = H = 256
    T, B = 2560, 256
    G = 4 * H
    x, iW, b, sW, lengths = layer_inputs(torch, gen, 4, T, B, IN, H)
    xb, iW16 = x.to(torch.bfloat16), iW.to(torch.bfloat16)
    fn, plain = rnn_cuda.lstm_layer_tm_train_bf16, rnn_cuda.lstm_layer_tm_train_plain
    errs = {"h": 0.0, "c": 0.0}
    for backward in (False, True):
        h, c = fn(xb, iW, b, sW, backward, lengths)
        wh, wc = plain(xb, iW, b, sW, backward, lengths)
        h1 = rnn_cuda.lstm_layer_tm_bf16(xb, iW, b, sW, backward, lengths)
        torch.cuda.synchronize()
        if h.dtype != torch.bfloat16 or c.dtype != torch.bfloat16:
            raise AssertionError(f"K8-bf16: outputs {h.dtype}, {c.dtype}")
        if not torch.equal(h, h1):
            raise AssertionError(f"K8-bf16 (backward={backward}): h is not K1-bf16's h bit for bit")
        errs["h"] = max(errs["h"], (h.float() - wh.float()).abs().max().item())
        errs["c"] = max(errs["c"], ((c.float() - wc.float()).abs()
                                    / wc.float().abs().clamp(min=1.0)).max().item())
        del h, c, wh, wc, h1
    log(f"K8-bf16 at T={T}, B={B}: max |kernel - plain| h {errs['h']:.3e}, c relative to "
        f"max(1, |c|) {errs['c']:.3e} (band 1e-2); h bit-equal to K1-bf16's, both directions")
    if not (errs["h"] <= 1e-2 and errs["c"] <= 1e-2):
        raise AssertionError(f"K8-bf16: outside its band {errs}")
    ref = cudnn_lstm(torch, iW, b, sW)
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        x.clone().requires_grad_(), lengths.clamp(min=1).cpu(), enforce_sorted=False)
    times = alternated_ms(torch, {
        "k8_bf16": lambda: fn(xb, iW16, b, sW, True, lengths),
        "k1_bf16": lambda: rnn_cuda.lstm_layer_tm_bf16(xb, iW16, b, sW, True, lengths),
        "cudnn": lambda: ref(packed)}, ALTERNATED_REPS)
    ms, k1_ms, library_ms = (statistics.median(times[k]) for k in ("k8_bf16", "k1_bf16", "cudnn"))
    plain_ms = cuda_ms(torch, lambda: plain(xb, iW16, b, sW, True, lengths), 1)
    nvalid = int(lengths.sum().item())
    bms, by = bound(2 * (nvalid * IN + IN * G + 2 * T * B * H) + 4 * (G + H * G + B),
                    2 * nvalid * H * G, peak, 2 * nvalid * IN * G)
    log(f"K8-bf16 at T={T}, B={B}, IN=H={H}, alternated: K8-bf16 {spread(times['k8_bf16'])} = "
        f"{1e3 * ms / T:.3f} us a step; K1-bf16 {spread(times['k1_bf16'])}; K8-bf16/K1-bf16 "
        f"{ms / k1_ms:.3f}; cuDNN training-mode forward (f32) {spread(times['cudnn'])}; "
        f"kernel/cuDNN {ms / library_ms:.3f}; plain {plain_ms:.1f} ms; bound {bms:.3f} ms ({by})")
    from flappie_tpu_torch.ops import cuda_build

    log("K8-bf16 ptxas: " + "; ".join(
        f"R={r} " + ptxas_usage(cuda_build.build_log.get("lstm", ""),
                                f"cluster_rnn_kernelILi4ELi{r}ELb1ELb0E13__nv_bfloat16E")
        for r in (1, 2, 4, 8, 12, 16, 20)))
    return row("lstm_layer_train_bf16", "K8-bf16", "lstm.cu", "rnn_pallas.py:278",
               "r941_native_train_bf16", "lstm_layer_train_bf16", max_abs_err=errs["h"], ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)


# kind -> (id, gates, p1 wrapper, its f32 twin, source, and for each stream
# the run and counter that supply the launch count) of the rnn-``default``
# recurrences; every one replaces the step product of rnn_pallas.py:172
P1_LAYERS = {
    "lstm": ("K1-default", 4, "lstm_layer_tm_p1", "lstm_layer_tm", "lstm_p1.cu",
             ("r941_native_default", "lstm_layer_p1"),
             ("r941_native_fast_default", "lstm_layer_bf16_p1")),
    "lstm_train": ("K8-default", 4, "lstm_layer_tm_train_p1", "lstm_layer_tm_train", "lstm_p1.cu",
                   ("r941_native_train_default", "lstm_layer_train_p1"),
                   ("r941_native_train_bf16_default", "lstm_layer_train_bf16_p1")),
    "grumod": ("K7-default", 3, "grumod_layer_tm_p1", "grumod_layer_tm", "grumod_p1.cu",
               ("r941_5mC_default", "grumod_layer_p1"),
               ("r941_5mC_fast_default", "grumod_layer_bf16_p1")),
}
# the one-pass recurrences' band against their plain twins, on both
# streams: max |delta| <= P1_MAX max(1, |value|) and mean |delta| <=
# P1_MEAN over the whole walk, and a mean <= P1_EARLY over the first
# P1_STEPS steps each row walks.  Kernel and twin sum the same exact
# products in f32 in other orders; where an h's two sums straddle a bf16
# rounding boundary the next product reads it one bf16 ulp apart, and the
# state carries that, so over 2560 steps the sound distance grows toward
# the f32 step's own (tests/test_torch_cuda.py).  Over the first steps
# such flips are still rare, and the f32 step (the control: a kernel that
# did not round h or sW) must lie at least 3 P1_EARLY from the twin there.
# P1_EARLY sits between the readings (H100, T=2560, B=256): the sound runs'
# largest first-steps mean 7.8e-6, the control's smallest 1.14e-4.
P1_MAX, P1_MEAN, P1_STEPS, P1_EARLY = 1e-2, 1e-4, 16, 1.5e-5
# the (stream, ff level, backward) cases check_layer_p1 holds to the band:
# the f32 stream both ways, the one-pass affine and the bf16 stream one
# way each (check_p1_rows walks both streams both ways at every rows a
# cluster; the run's time budget keeps 4 of the 6 cases at T=2560)
P1_CASES = (("f32", None, False), ("f32", None, True), ("f32", "default", True),
            ("bf16", None, False))


def first_steps(torch, T: int, lengths, backward: bool, steps: int):
    """[T, B, 1] bool: the first ``steps`` valid steps each row walks
    (from t = 0 forward, from its length down backward)."""
    t = torch.arange(T, device=lengths.device)[:, None]
    s = (lengths[None, :] - 1 - t) if backward else t
    return ((s >= 0) & (s < steps) & (t < lengths[None, :]))[..., None]


def p1_distance(got, want, early) -> tuple:
    """(max |delta| / max(1, max |want|), mean |delta|, mean |delta| over
    the steps ``early`` marks)."""
    d = (got.float() - want.float()).abs()
    scale = max(1.0, want.float().abs().max().item())
    n = early.sum().item() * d.shape[-1]
    return d.max().item() / scale, d.mean().item(), (d * early).sum().item() / n


def at_ff_default(fn):
    """``fn`` run with FLAPPIE_TPU_MATMUL_PRECISION at default."""
    def run():
        with precision_levels(ff="default"):
            return fn()
    return run


def check_layer_p1(torch, peak: dict, gen, kind: str) -> list:
    """The rnn-``default`` variant of K1, K8 or K7 (the cluster recurrence
    with the one-pass step product on the tensor cores, csrc/lstm_p1.cu /
    grumod_p1.cu on csrc/cluster_rnn_mma.cuh) at
    T=2560, B=256, IN=H=256, ragged lengths: on the f32 stream (the f32
    affine and, at FLAPPIE_TPU_MATMUL_PRECISION=default, the one-pass
    affine) and on the bf16 stream, in the directions of P1_CASES, against
    its plain twin (rdot one pass, the same ff) inside the P1 band; beside it, the
    control, the same layer's kernel with the f32 step on the same inputs
    (the f32 kernel, the one-pass affine's f32 kernel, K1-/K8-/K7-bf16),
    must lie outside the band by at least 3x on the mean over the first
    steps, so a one-pass kernel that computed the f32 step would fail.
    Every reading is logged before any gate fails.  Timed over 10 runs
    alternated with the control on each stream; the plain twin's time is
    that of its last run in the band on each stream at ff high.  No library
    call computes the one-pass step over an f32 state: library_ms is null.
    Returns the f32-stream row and the bf16-stream row."""
    from flappie_tpu_torch.ops import rnn_cuda

    kid, gates, wrapper, twin, source, f32_run, bf16_run = P1_LAYERS[kind]
    fn, f32 = getattr(rnn_cuda, wrapper), getattr(rnn_cuda, twin)
    plain = getattr(rnn_cuda, twin + "_plain")
    IN = H = 256
    T, B = 2560, 256
    G = gates * H
    x, iW, b, sW, lengths = layer_inputs(torch, gen, gates, T, B, IN, H)
    xb = x.to(torch.bfloat16)
    pair = (lambda o: o) if kind == "lstm_train" else (lambda o: (o,))
    err = {"f32": 0.0, "bf16": 0.0}
    logs, bad = [], []
    sound_early, control_early = 0.0, float("inf")
    plain_at = {}
    for stream, ff, backward in P1_CASES:
        xs = x if stream == "f32" else xb
        early = first_steps(torch, T, lengths, backward, P1_STEPS)
        with precision_levels(ff=ff):
            got = fn(xs, iW, b, sW, backward, lengths)
            ctl = f32(xs, iW, b, sW, backward, lengths)
        want, plain_at[stream, ff] = event_ms(torch, lambda: plain(
            xs, iW, b, sW, backward, lengths, rdot="bf16", ff="bf16" if ff else "highest"))
        for name, g, c, w in zip("hc", pair(got), pair(ctl), pair(want)):
            if g.dtype != xs.dtype:
                bad.append(f"{name} {stream}: {g.dtype}")
            dmax, dmean, dearly = p1_distance(g, w, early)
            cmax, cmean, cearly = p1_distance(c, w, early)
            err[stream] = max(err[stream], dmax)
            sound_early, control_early = max(sound_early, dearly), min(control_early, cearly)
            what = f"{name} {stream} ff={ff or 'high'} bw={int(backward)}"
            logs.append(f"{what}: max {dmax:.2e} mean {dmean:.2e} first {P1_STEPS} steps "
                        f"{dearly:.2e}; control max {cmax:.2e} mean {cmean:.2e} first steps "
                        f"{cearly:.2e}")
            if not (dmax <= P1_MAX and dmean <= P1_MEAN and dearly <= P1_EARLY):
                bad.append(f"{what} outside the band")
            if not cearly >= 3 * P1_EARLY:
                bad.append(f"{what}: the control lies within 3x the band ({cearly:.2e})")
        del got, ctl, want
    log(f"{kid} at T={T}, B={B} against its plain twin (band max {P1_MAX} x max(1, |value|), "
        f"mean {P1_MEAN}, mean over the first {P1_STEPS} steps {P1_EARLY}; the control, the "
        f"f32 step, at least {3 * P1_EARLY:.0e} there): " + "; ".join(logs))
    log(f"{kid}: the sound runs' largest first-steps mean {sound_early:.3e}, the control's "
        f"smallest {control_early:.3e} (ratio {control_early / max(sound_early, 1e-30):.1f})")
    if bad:
        raise AssertionError(f"{kid}: " + "; ".join(bad))
    iW16 = iW.to(torch.bfloat16)
    fns = {"one_pass": lambda: fn(x, iW, b, sW, True, lengths),
           "one_pass_ff": at_ff_default(lambda: fn(x, iW, b, sW, True, lengths)),
           "f32": lambda: f32(x, iW, b, sW, True, lengths),
           "one_pass_bf16": lambda: fn(xb, iW16, b, sW, True, lengths),
           "bf16": lambda: f32(xb, iW16, b, sW, True, lengths)}
    times = alternated_ms(torch, fns, ALTERNATED_REPS)
    med = {k: statistics.median(v) for k, v in times.items()}
    plain_ms, plain_bf16_ms = plain_at["f32", None], plain_at["bf16", None]
    nvalid = int(lengths.sum().item())
    outs = T * B * H * (2 if kind == "lstm_train" else 1)
    # the one-pass products are bf16 tensor work, whatever runs them: the
    # step's on the f32 stream (its affine f32), both on the bf16 stream
    # and at ff one pass
    f32_bytes = 4 * (nvalid * IN + IN * G + G + H * G + B + outs)
    bms, by = bound(f32_bytes, 2 * nvalid * IN * G, peak, 2 * nvalid * H * G)
    bms16, by16 = bound(2 * (nvalid * IN + IN * G + outs) + 4 * (G + H * G + B), 0, peak,
                        2 * nvalid * (IN + H) * G)
    bms_ff, by_ff = bound(f32_bytes, 0, peak, 2 * nvalid * (IN + H) * G)
    log(f"{kid} at T={T}, B={B}, IN=H={H}, alternated: the one-pass step, f32 affine "
        f"{spread(times['one_pass'])} = {1e3 * med['one_pass'] / T:.3f} us a step; with the "
        f"one-pass affine {spread(times['one_pass_ff'])}; the f32 kernel {spread(times['f32'])}, "
        f"one-pass/f32 {med['one_pass'] / med['f32']:.3f}; bf16 stream: one-pass "
        f"{spread(times['one_pass_bf16'])}, its bf16 twin {spread(times['bf16'])}, ratio "
        f"{med['one_pass_bf16'] / med['bf16']:.3f}; plain {plain_ms:.1f} ms, on the bf16 stream "
        f"{plain_bf16_ms:.1f} ms; bound {bms:.3f} ms ({by}), with the one-pass affine "
        f"{bms_ff:.3f} ms ({by_ff}), on the bf16 stream {bms16:.3f} ms ({by16}); library: none "
        f"computes the one-pass step over an f32 state")
    from flappie_tpu_torch.ops import cuda_build

    text = cuda_build.build_log.get(source[:-3], "")
    log(f"{kid} ptxas ({source}): the tensor-core step at {gates} gates (every instantiation: "
        f"n-tiles 1-3, {'WANT_C, ' if gates == 4 else ''}stream) "
        + ptxas_usage(text, f"cluster_rnn_mma_kernelILi{gates}E")
        + "; the f32 step after the one-pass affine (R = 20 ... 1) "
        + ptxas_usage(text, f"cluster_rnn_kernelILi{gates}ELi"))
    (run, counter), (run16, counter16) = f32_run, bf16_run
    return [row(counter, kid, source, "rnn_pallas.py:172", run, counter, max_abs_err=err["f32"],
                ms=med["one_pass"], plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None),
            row(counter16, kid + "-bf16", source, "rnn_pallas.py:172", run16, counter16,
                max_abs_err=err["bf16"], ms=med["one_pass_bf16"], plain_ms=plain_bf16_ms,
                bound_ms=bms16, bound_by=by16, library_ms=None)]


# (B, T) of the one-pass layers at every rows-a-cluster instantiation of
# the tensor-core step (R = 1, 1, 2, 2, 4, 8, 12, 16, 20; the last cluster
# of B=257 holding 17 rows), as tests/test_torch_cuda.py walks them
P1_ROWS = ((1, 40), (3, 40), (19, 64), (24, 40), (33, 40), (100, 40), (150, 40), (240, 40),
           (257, 40))
# rows check_p1_rows holds the band over at each B: its means are over
# rows (it was read at 256), and over one row a bf16 rounding flip of h
# within the first steps, after which that row's walk diverges, is common
# (GRU-mod's more than the LSTM's: p1_band.py, PERF.md), so a smaller B
# runs a batch of at least this many rows, B rows a launch
P1_POOL_ROWS = 128


def p1_rows_outputs(torch, rnn_cuda, cell: str, args: tuple, B: int, level: str = "p1") -> tuple:
    """(pairs of a one-pass output and its plain twin's, the f32-step
    control's h, whether K8-default's h is K1-default's) of ``cell`` on
    ``args`` (x, iW, b, sW, backward, lengths): ``"lstm"``, K1-default's h
    and K8-default's c; ``"grumod"``, K7-default's h.  The one-pass layers
    run B rows a launch (the instantiation B picks), the control and the
    twin all rows at once (a row's walk does not depend on its batch).
    ``level`` "h3": the same for the three-pass layers (K1-, K8-,
    K7-high3), whose control is the one-pass layer."""
    x, iW, b, sW, backward, lengths = args
    sfx, rdot = ("_p1", "bf16") if level == "p1" else ("_h3", "bf16x3")
    parts = [(x[:, i:i + B].contiguous(), lengths[i:i + B].contiguous())
             for i in range(0, x.shape[1], B)]

    def launched(fn):
        outs = [fn(xp, iW, b, sW, backward, lp) for xp, lp in parts]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o, dim=1) for o in zip(*outs))
        return torch.cat(outs, dim=1)

    def control(name):
        return getattr(rnn_cuda, name + ("" if level == "p1" else "_p1"))(*args)

    if cell == "grumod":
        got = launched(getattr(rnn_cuda, "grumod_layer_tm" + sfx))
        want = rnn_cuda.grumod_layer_tm_plain(*args, rdot=rdot)
        return ((got, want),), control("grumod_layer_tm"), True
    h1 = launched(getattr(rnn_cuda, "lstm_layer_tm" + sfx))
    h8, c8 = launched(getattr(rnn_cuda, "lstm_layer_tm_train" + sfx))
    wh, wc = rnn_cuda.lstm_layer_tm_train_plain(*args, rdot=rdot)
    return ((h1, wh), (c8, wc)), control("lstm_layer_tm"), torch.equal(h1, h8)


# the cells check_p1_rows walks at each level: (cell, gates, the kernels it
# holds)
P1_ROW_CELLS = {"p1": (("lstm", 4, "K1-default / K8-default"), ("grumod", 3, "K7-default")),
                "h3": (("lstm", 4, "K1-high3 / K8-high3"), ("grumod", 3, "K7-high3"))}


def row_band(level: str, stream: str) -> tuple:
    """(max, mean, first-steps mean) of the band a layer at ``level``
    ("p1" or "h3") holds to its plain twin on ``stream``."""
    if level == "p1":
        return P1_MAX, P1_MEAN, P1_EARLY
    top = H3_MAX if stream == "f32" else H3_MAX_BF16
    return top, top, H3_EARLY


def check_p1_rows(torch, gen, level: str = "p1") -> None:
    """The tensor-core step at every R, IN=H=256, ragged lengths including
    0 and T, both directions, on the f32 stream (f32 affine) and the bf16
    stream: K1-default and K8-default (K8-default's h bit-equal to
    K1-default's, h and c inside the P1 band against the plain twin) and
    K7-default (h inside the band), each with its f32-step control at
    least 3 P1_EARLY from the twin's h over the first steps (its smallest
    distance is logged), as check_layer_p1 holds them at T=2560; each band
    over at least P1_POOL_ROWS rows, launched B rows at a time.  ``level``
    "h3": the three-pass layers (K1-, K8-, K7-high3) by the same rules in
    the H3 band (row_band), their control the one-pass layer, at least 3
    H3_EARLY from the twin over the first steps."""
    from flappie_tpu_torch.ops import rnn_cuda

    IN = H = 256
    bad = []
    early_band = row_band(level, "f32")[2]
    for cell, gates, kids in P1_ROW_CELLS[level]:
        logs = []
        for B, T in P1_ROWS:
            rows = -(-P1_POOL_ROWS // B) * B
            # (layer_inputs gives row 0 length T and row 1 length 0)
            x, iW, b, sW, lengths = layer_inputs(torch, gen, gates, T, max(rows, 2), IN, H)
            x, lengths = x[:, :rows].contiguous(), lengths[:rows].contiguous()
            R = rnn_cuda.info_plan(f"{cell}_layer_{level}", B)[0]
            worst = {"early": 0.0, "max": 0.0, "control": float("inf")}
            for stream, xs in (("f32", x), ("bf16", x.to(torch.bfloat16))):
                for backward in (False, True):
                    early = first_steps(torch, T, lengths, backward, P1_STEPS)
                    pairs, ctl, k8_is_k1 = p1_rows_outputs(
                        torch, rnn_cuda, cell, (xs, iW, b, sW, backward, lengths), B, level)
                    torch.cuda.synchronize()
                    what = f"{kids} B={B} (R={R}) {stream} bw={int(backward)}"
                    if not k8_is_k1:
                        bad.append(f"{what}: K8's h is not K1's")
                    top, mean, first = row_band(level, stream)
                    for got, want in pairs:
                        dmax, dmean, dearly = p1_distance(got, want, early)
                        worst["early"] = max(worst["early"], dearly)
                        worst["max"] = max(worst["max"], dmax)
                        if not (dmax <= top and dmean <= mean and dearly <= first):
                            bad.append(f"{what}: outside the band (max {dmax:.2e}, mean "
                                       f"{dmean:.2e}, first steps {dearly:.2e})")
                    control = p1_distance(ctl, pairs[0][1], early)[2]
                    worst["control"] = min(worst["control"], control)
                    if control < 3 * early_band:
                        bad.append(f"{what}: the control lies {control:.2e} from the twin over "
                                   f"the first steps, within 3x the band's {early_band:.0e}")
            logs.append(f"B={B} R={R} ({rows // B} launches): max {worst['max']:.2e}, first "
                        f"steps {worst['early']:.2e}, control {worst['control']:.2e}")
        control = "the f32 step" if level == "p1" else "the one-pass step"
        log(f"{kids} at every R (T=40-64, both streams and directions, at least {P1_POOL_ROWS} "
            f"rows a band; " + ("K8's h bit-equal to K1's, h and c" if cell == "lstm" else "h")
            + f" inside the {level} band, the control ({control}) at least 3x its first-steps "
            f"mean outside): " + "; ".join(logs))
    if bad:
        raise AssertionError(f"{level} rows: " + "; ".join(bad))


# kind -> (id, gates, three-pass wrapper, its f32-step twin, its one-pass
# twin, source, and for each stream the run and counter that supply the
# launch count) of the rnn-``high`` recurrences on the card; every one
# replaces the step product of rnn_pallas.py:161 (_dot_bf16x3, which
# _make_rdot:172 runs at "high3")
H3_LAYERS = {
    "lstm": ("K1-high3", 4, "lstm_layer_tm_h3", "lstm_layer_tm", "lstm_layer_tm_p1", "lstm_h3.cu",
             ("r941_native_high", "lstm_layer_h3"),
             ("r941_native_fast_high", "lstm_layer_bf16_h3")),
    "lstm_train": ("K8-high3", 4, "lstm_layer_tm_train_h3", "lstm_layer_tm_train",
                   "lstm_layer_tm_train_p1", "lstm_h3.cu",
                   ("r941_native_train_high", "lstm_layer_train_h3"),
                   ("r941_native_train_bf16_high", "lstm_layer_train_bf16_h3")),
    "grumod": ("K7-high3", 3, "grumod_layer_tm_h3", "grumod_layer_tm", "grumod_layer_tm_p1",
               "grumod_h3.cu", ("r941_5mC_high", "grumod_layer_h3"),
               ("r941_5mC_fast_high", "grumod_layer_bf16_h3")),
}
# the three-pass layers' band against their plain twins: max |delta| <=
# H3_MAX on the f32 stream (the f32 layers' own band, absolute as
# check_layer's), <= H3_MAX_BF16 max(1, |value|) on the bf16 stream (one bf16
# ulp of a stored output, as K1-bf16's band: kernel and twin carry f32 states
# a few f32 ulps apart and round each output once), and a mean <= H3_EARLY
# over the first P1_STEPS steps each row walks, where the one-pass kernel (the
# control) must lie at least 3 H3_EARLY from the twin.  Kernel and twin sum
# the same exact products of each pass in other orders; a flip of h_hi is
# carried by h_lo, so unlike the one-pass step no bf16 flip of h moves a walk.
# H3_EARLY sits between the readings (H100, T=2560, B=256 and every R): the
# sound runs' largest first-steps mean 1.65e-6 (the bf16 stream's output
# roundings; 1.5e-7 on the f32 stream), the one-pass control's smallest
# 1.11e-4.
H3_MAX, H3_MAX_BF16, H3_EARLY = 1e-4, 1e-2, 1e-5


def h3_distance(got, want, early, stream: str) -> tuple:
    """p1_distance with the max absolute on the f32 stream (H3_MAX's
    scale) and relative to max(1, max |want|) on the bf16 stream."""
    dmax, dmean, dearly = p1_distance(got, want, early)
    if stream == "f32":
        dmax = (got.float() - want.float()).abs().max().item()
    return dmax, dmean, dearly


# the crafted probe of the three-pass kernels (h3_probe): steps, rows, and for
# each cell its biases by gate (one value for every unit) and sW's scale by
# gate; sW's entries are scale (1 + 3 2^-9), whose bf16 remainder is -scale
# 2^-9, and the biases give h walks whose bf16 remainders are large
PROBE_T, PROBE_B = 4, 16
PROBE_CELLS = {4: ((0.4, -0.75, 0.4, 1.1), (2.0 ** -8, 2.0 ** -9, 2.0 ** -8, 2.0 ** -9)),
               3: ((-0.3, 1.1, -0.3), (2.0 ** -8,) * 3)}


def h3_probe(torch, kind: str) -> str:
    """The crafted probe where a kernel that ran the f32 step cannot hide
    (on the f32 stream): iW = 0 and a bias that is one value a gate, so xa
    is fixed and every unit of every row walks the same h; sW one value a
    gate column with a large bf16 remainder, so every pass sums 256 equal
    exact products (exact in any order) and the three-pass twin drops the
    lo.lo term, 256 h_lo sW_lo, coherently.  Over PROBE_T steps the
    three-pass kernel must lie within a quarter of the f32 twin's distance
    from the three-pass twin (the known amount: the plain f32 and one-pass
    versions against the three-pass twin on the same inputs), while the
    f32 kernel and the one-pass kernel lie at least half of their twins'
    distance from it.  Returns the log line; raises after logging."""
    from flappie_tpu_torch.ops import rnn_cuda

    kid, gates, wrapper, twin, p1_name, *_ = H3_LAYERS[kind]
    fn, f32, p1 = (getattr(rnn_cuda, n) for n in (wrapper, twin, p1_name))
    plain = getattr(rnn_cuda, twin + "_plain")
    dev = torch.device("cuda")
    H = IN = 256
    biases, scales = PROBE_CELLS[gates]
    x = torch.randn(PROBE_T, PROBE_B, IN, device=dev)
    iW = torch.zeros(IN, gates * H, device=dev)
    b = torch.cat([torch.full((H,), v, device=dev) for v in biases])
    sW = torch.cat([torch.full((H, H), s * (1 + 3 * 2.0 ** -9), device=dev) for s in scales], 1)
    h = (lambda o: o[0]) if kind == "lstm_train" else (lambda o: o)
    args = (x, iW, b, sW, False, None)
    with precision_levels(ff="high"):
        want = h(plain(*args, rdot="bf16x3"))
        known = {"f32": (h(f32(*args)), h(plain(*args))),
                 "one-pass": (h(p1(*args)), h(plain(*args, rdot="bf16")))}
        got = h(fn(*args))
    torch.cuda.synchronize()
    d_h3 = (got - want).abs().max().item()
    found = {k: ((k_out - want).abs().max().item(), (k_plain - want).abs().max().item())
             for k, (k_out, k_plain) in known.items()}
    line = (f"{kid} crafted probe (T={PROBE_T}, B={PROBE_B}, every unit one walk, sW's "
            f"remainders 2^-9 of its entries): max |three-pass kernel - twin| {d_h3:.3e}; "
            + "; ".join(f"{k} kernel {kd:.3e} from the twin (its plain version {pd:.3e})"
                        for k, (kd, pd) in found.items()))
    log(line)
    (f32_kernel, f32_known), (p1_kernel, p1_known) = found["f32"], found["one-pass"]
    if not (f32_known > 0 and d_h3 <= 0.25 * f32_known and f32_kernel >= 0.5 * f32_known
            and p1_kernel >= 0.5 * p1_known):
        raise AssertionError(f"{kid} crafted probe: {line}")
    return line


def check_layer_h3(torch, peak: dict, gen, kind: str) -> list:
    """The rnn-``high`` variant of K1, K8 or K7 on the card (the cluster
    recurrence with the three-pass step product on the tensor cores,
    csrc/lstm_h3.cu / grumod_h3.cu on csrc/cluster_rnn_mma.cuh) at
    T=2560, B=256, IN=H=256, ragged lengths: on the f32 stream (the f32
    affine and, at FLAPPIE_TPU_MATMUL_PRECISION=default, the one-pass
    affine) and on the bf16 stream, both directions, against its plain
    twin (rdot three passes, the same ff) inside the H3 band; beside it the
    control, the same layer's one-pass kernel on the same inputs, must lie
    at least 3 H3_EARLY from the twin over the first steps; then
    h3_probe, where the f32 step is told apart too.  Every reading is
    logged before any gate fails.  Timed over 10 runs alternated with the
    f32-step and one-pass kernels on each stream; the plain twin's time is
    that of its backward run in the band on each stream at ff high.  No
    library call computes the three-pass step over an f32 state:
    library_ms is null.
    Returns the f32-stream row and the bf16-stream row."""
    from flappie_tpu_torch.ops import rnn_cuda

    kid, gates, wrapper, twin, p1_name, source, f32_run, bf16_run = H3_LAYERS[kind]
    fn, f32, p1 = (getattr(rnn_cuda, n) for n in (wrapper, twin, p1_name))
    plain = getattr(rnn_cuda, twin + "_plain")
    IN = H = 256
    T, B = 2560, 256
    G = gates * H
    x, iW, b, sW, lengths = layer_inputs(torch, gen, gates, T, B, IN, H)
    xb = x.to(torch.bfloat16)
    pair = (lambda o: o) if kind == "lstm_train" else (lambda o: (o,))
    err = {"f32": 0.0, "bf16": 0.0}
    logs, bad = [], []
    sound_early, control_early = 0.0, float("inf")
    plain_at = {}
    for stream, xs, ff in (("f32", x, None), ("f32", x, "default"), ("bf16", xb, None)):
        for backward in (False, True):
            early = first_steps(torch, T, lengths, backward, P1_STEPS)
            with precision_levels(ff=ff):
                got = fn(xs, iW, b, sW, backward, lengths)
                ctl = p1(xs, iW, b, sW, backward, lengths)
            want, plain_at[stream, ff] = event_ms(torch, lambda: plain(
                xs, iW, b, sW, backward, lengths, rdot="bf16x3", ff="bf16" if ff else "highest"))
            top = H3_MAX if stream == "f32" else H3_MAX_BF16
            for name, g, c, w in zip("hc", pair(got), pair(ctl), pair(want)):
                if g.dtype != xs.dtype:
                    bad.append(f"{name} {stream}: {g.dtype}")
                dmax, dmean, dearly = h3_distance(g, w, early, stream)
                cmax, cmean, cearly = h3_distance(c, w, early, stream)
                err[stream] = max(err[stream], dmax)
                sound_early, control_early = max(sound_early, dearly), min(control_early, cearly)
                what = f"{name} {stream} ff={ff or 'high'} bw={int(backward)}"
                logs.append(f"{what}: max {dmax:.2e} mean {dmean:.2e} first {P1_STEPS} steps "
                            f"{dearly:.2e}; one-pass control max {cmax:.2e} mean {cmean:.2e} "
                            f"first steps {cearly:.2e}")
                if not (dmax <= top and dearly <= H3_EARLY):
                    bad.append(f"{what} outside the band")
                if not cearly >= 3 * H3_EARLY:
                    bad.append(f"{what}: the control lies within 3x the band ({cearly:.2e})")
            del got, ctl, want
    log(f"{kid} at T={T}, B={B} against its plain twin (band max {H3_MAX} on the f32 stream, "
        f"{H3_MAX_BF16} x max(1, |value|) on the bf16 stream, mean over the first {P1_STEPS} "
        f"steps {H3_EARLY}; the control, the one-pass step, at least {3 * H3_EARLY:.0e} there): "
        + "; ".join(logs))
    log(f"{kid}: the sound runs' largest first-steps mean {sound_early:.3e}, the control's "
        f"smallest {control_early:.3e} (ratio {control_early / max(sound_early, 1e-30):.1f})")
    try:
        h3_probe(torch, kind)
    except AssertionError as exc:
        bad.append(str(exc))
    if bad:
        raise AssertionError(f"{kid}: " + "; ".join(bad))
    iW16 = iW.to(torch.bfloat16)
    fns = {"three_pass": lambda: fn(x, iW, b, sW, True, lengths),
           "three_pass_ff": at_ff_default(lambda: fn(x, iW, b, sW, True, lengths)),
           "f32": lambda: f32(x, iW, b, sW, True, lengths),
           "one_pass": lambda: p1(x, iW, b, sW, True, lengths),
           "three_pass_bf16": lambda: fn(xb, iW16, b, sW, True, lengths),
           "bf16": lambda: f32(xb, iW16, b, sW, True, lengths),
           "one_pass_bf16": lambda: p1(xb, iW16, b, sW, True, lengths)}
    times = alternated_ms(torch, fns, ALTERNATED_REPS)
    med = {k: statistics.median(v) for k, v in times.items()}
    plain_ms, plain_bf16_ms = plain_at["f32", None], plain_at["bf16", None]
    nvalid = int(lengths.sum().item())
    outs = T * B * H * (2 if kind == "lstm_train" else 1)
    # the three passes are bf16 tensor work, whatever runs them; the f32
    # stream's affine f32, else one pass
    f32_bytes = 4 * (nvalid * IN + IN * G + G + H * G + B + outs)
    bms, by = bound(f32_bytes, 2 * nvalid * IN * G, peak, 3 * 2 * nvalid * H * G)
    bms16, by16 = bound(2 * (nvalid * IN + IN * G + outs) + 4 * (G + H * G + B), 0, peak,
                        2 * nvalid * (IN + 3 * H) * G)
    bms_ff, by_ff = bound(f32_bytes, 0, peak, 2 * nvalid * (IN + 3 * H) * G)
    log(f"{kid} at T={T}, B={B}, IN=H={H}, alternated: the three-pass step, f32 affine "
        f"{spread(times['three_pass'])} = {1e3 * med['three_pass'] / T:.3f} us a step; with the "
        f"one-pass affine {spread(times['three_pass_ff'])}; the f32-step kernel "
        f"{spread(times['f32'])} (three-pass/f32 {med['three_pass'] / med['f32']:.3f}); the "
        f"one-pass kernel {spread(times['one_pass'])} (three-pass/one-pass "
        f"{med['three_pass'] / med['one_pass']:.3f}); bf16 stream: three-pass "
        f"{spread(times['three_pass_bf16'])}, the f32 step {spread(times['bf16'])}, one pass "
        f"{spread(times['one_pass_bf16'])}; plain {plain_ms:.1f} ms, on the bf16 stream "
        f"{plain_bf16_ms:.1f} ms; bound {bms:.3f} ms ({by}), with the one-pass affine "
        f"{bms_ff:.3f} ms ({by_ff}), on the bf16 stream {bms16:.3f} ms ({by16}); library: none "
        f"computes the three-pass step over an f32 state")
    from flappie_tpu_torch.ops import cuda_build

    text = cuda_build.build_log.get(source[:-3], "")
    log(f"{kid} ptxas ({source}): the three-pass tensor-core step at {gates} gates (every "
        f"instantiation: n-tiles 1-3, {'WANT_C, ' if gates == 4 else ''}stream) "
        + ptxas_usage(text, f"cluster_rnn_mma_kernelILi{gates}E"))
    (run, counter), (run16, counter16) = f32_run, bf16_run
    return [row(counter, kid, source, "rnn_pallas.py:161", run, counter, max_abs_err=err["f32"],
                ms=med["three_pass"], plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None),
            row(counter16, kid + "-bf16", source, "rnn_pallas.py:161", run16, counter16,
                max_abs_err=err["bf16"], ms=med["three_pass_bf16"], plain_ms=plain_bf16_ms,
                bound_ms=bms16, bound_by=by16, library_ms=None)]


def check_affine_bf16_f32(torch, peak: dict, gen) -> dict:
    """The one-pass affine with an f32 output (csrc/affine.cuh, the bf16
    kernels' f32 epilogue; FLAPPIE_TPU_MATMUL_PRECISION=default on the f32
    stream) at M = 655,360, IN=256, G=1024 and G=768, x and iW rounded to
    bf16: each element within f32 reassociation of its plain version
    (the same exact products summed in another order: K 2^-23 sum |x w|
    plus 2^-23 |value|), on its wgmma path, timed over 10 runs alternated
    with the single torch calls of the same function (bf16 operands into
    an f32 output: torch.addmm and torch.baddbmm with out_dtype=float32,
    each held to the plain version by the same rule; the fastest is its
    library time), torch.mm(x, iW, out_dtype=float32) (the product alone,
    no bias: logged beside, not the same function), torch.addmm in bf16
    (the bf16-output call) and the bf16-output kernel; the device kernels
    each f32-output call launches are logged from torch.profiler.
    Returns the G=1024 row."""
    from flappie_tpu_torch.ops import cuda_build, rnn_cuda

    dev = torch.device("cuda")
    M, K = AFFINE_SHAPE
    out = None
    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
    for G in (1024, 768):
        iW = (torch.randn(K, G, generator=gen, device=dev) / K ** 0.5).to(torch.bfloat16)
        b = torch.randn(G, generator=gen, device=dev) * 0.2
        b16 = b.to(torch.bfloat16)
        before = path_launches(rnn_cuda)
        got = rnn_cuda.affine_bf16_f32(x, iW, b)
        if path_launches(rnn_cuda) != before:
            raise AssertionError("affine_bf16_f32 counted on the bf16-output affine's counters")
        want = rnn_cuda.affine_bf16_f32_plain(x, iW, b)
        delta = (got - want).abs()
        noise = (x.float().abs() @ iW.float().abs()) * (K * 2.0 ** -23) + want.abs() * 2.0 ** -23
        bad = int((delta > noise).sum().item())
        err, equal = delta.max().item(), int((delta == 0).sum().item())
        if got.dtype != torch.float32 or bad:
            raise AssertionError(f"affine_bf16_f32 at G={G}: {bad} elements outside the f32 "
                                 f"reassociation error (max |delta| {err}), dtype {got.dtype}")
        f32 = torch.float32
        same_fn = {  # one torch call each, bf16 operands into an f32 output with the bias
            "addmm_f32": lambda: torch.addmm(b, x, iW, out_dtype=f32),
            "baddbmm_f32": lambda: torch.baddbmm(b, x[None], iW[None], out_dtype=f32)[0],
        }
        extra = {"mm_f32": lambda: torch.mm(x, iW, out_dtype=f32)}  # the product alone
        lib_err = {}
        for name, fn in list(same_fn.items()) + list(extra.items()):
            try:
                lib = fn()
            except (TypeError, RuntimeError) as exc:
                log(f"affine_bf16_f32 library call {name} at G={G}: not available ({exc})")
                same_fn.pop(name, None)
                extra.pop(name, None)
                continue
            if name in extra:
                del lib
                continue
            lib_err[name] = (lib - want).abs().max().item()
            lib_bad = int(((lib - want).abs() > noise).sum().item())
            if lib.dtype != f32 or lib_bad:
                raise AssertionError(f"{name} at G={G} is not the same function: {lib_bad} "
                                     f"elements outside the f32 reassociation error (max "
                                     f"|delta| {lib_err[name]}), dtype {lib.dtype}")
            del lib
        if not same_fn:
            raise AssertionError("affine_bf16_f32: no torch call of the same function ran")
        del got, want, delta, noise
        times = alternated_ms(torch, {
            "kernel": lambda: rnn_cuda.affine_bf16_f32(x, iW, b),
            "bf16_out": lambda: rnn_cuda.affine_bf16(x, iW, b),
            "addmm": lambda: torch.addmm(b16, x, iW), **same_fn, **extra}, ALTERNATED_REPS)
        ms, bf_ms, bf16_lib_ms = (statistics.median(times[k]) for k in (
            "kernel", "bf16_out", "addmm"))
        lib_name = min(same_fn, key=lambda k: statistics.median(times[k]))
        library_ms = statistics.median(times[lib_name])
        if G == 1024:
            profile_f32_gemms(torch, {**same_fn, **extra})
        plain_ms = cuda_ms(torch, lambda: rnn_cuda.affine_bf16_f32_plain(x, iW, b), 1)
        bms, by = bound(2 * (M * K + K * G) + 4 * (M * G + G), 0, peak, 2 * M * K * G)
        log(f"affine_bf16_f32 at M={M}, IN={K}, G={G}: {equal} of {M * G} elements equal to the "
            f"plain version's, max |delta| {err:.2e}, every one inside the f32 reassociation "
            f"error; kernel {spread(times['kernel'])}; the bf16-output kernel "
            f"{spread(times['bf16_out'])}; "
            + "; ".join(f"torch {k} {spread(times[k])}"
                        + (f" (max |delta| {lib_err[k]:.2e} to the plain version)"
                           if k in lib_err else " (no bias: not the same function)")
                        for k in [*same_fn, *extra])
            + f"; library time: {lib_name}, kernel/{lib_name} {ms / library_ms:.3f}; "
            f"torch.addmm bf16 "
            f"{spread(times['addmm'])} (kernel/addmm_bf16 {ms / bf16_lib_ms:.3f}); plain "
            f"{plain_ms:.3f} ms; bound {bms:.3f} ms ({by}) = {100 * bms / ms:.1f}% of the "
            f"kernel's time")
        if out is None:
            out = row("affine_bf16_f32", "affine-bf16-f32", "affine.cuh", "rnn_pallas.py:183",
                      "r941_native_default", "affine_bf16_f32", max_abs_err=err, ms=ms,
                      plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)
    log("affine_bf16_f32 ptxas: " + ptxas_usage(cuda_build.build_log.get("lstm", ""),
                                                "affine_bf16_kernelIf"))
    return out


def profile_f32_gemms(torch, calls: dict) -> None:
    """The device kernels each torch call of ``calls`` launches, with
    their device ms a call (torch.profiler, 3 calls each)."""
    from torch.profiler import ProfilerActivity, profile

    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        got = device_time(prof)
        if got is None:
            log(f"affine_bf16_f32 library call {name}: no device events recorded; not measured")
            continue
        log(f"affine_bf16_f32 library call {name}, device ms a call (profiler, 3 calls): "
            + "; ".join(f"{us / 1e3 / 3:.4f} {kname[:110]}"
                        for kname, us in sorted(got[2].items(), key=lambda kv: -kv[1])))


def check_kernels(torch, peak: dict, libs: dict) -> list:
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = [timed("check_layer", check_layer, torch, peak, gen, kind) for kind in LAYER_KERNELS]
    rows += [timed("check_affines", check_affine_f32, torch, peak, gen),
             timed("check_affines", check_affine_bf16, torch, peak, gen)]
    rows += [timed("check_layer_bf16", check_layer_bf16, torch, peak, gen, kind)
             for kind in BF16_LAYERS]
    rows += [timed("check_layer_bf16", check_layer_train_bf16, torch, peak, gen),
             timed("check_affines", check_affine_bf16_f32, torch, peak, gen)]
    for kind in P1_LAYERS:
        rows += timed("check_layer_p1", check_layer_p1, torch, peak, gen, kind)
    timed("check_p1_rows", check_p1_rows, torch, gen)
    for kind in H3_LAYERS:
        rows += timed("check_layer_h3", check_layer_h3, torch, peak, gen, kind)
    timed("check_h3_rows", check_p1_rows, torch, gen, "h3")
    timed("time_lstm_shapes", time_lstm_shapes, torch, gen)
    rows += [timed("check_conv12", check_conv12, torch, peak, gen, libs)]
    rows += [timed("check_seq", check_seq, torch, peak, gen, k) for k in SEQ_KERNELS]
    rows += (timed("check_scans", check_scans, torch, peak, gen, 4, libs)
             + timed("check_scans", check_scans, torch, peak, gen, 5, libs))
    rows += timed("check_bt_scans", check_bt_scans, torch, peak, gen, libs, "rle")
    for nbase in (4, 5):
        timed("check_bt_scans", check_bt_scans, torch, peak, gen, libs, "flipflop", nbase)
    timed("check_runnie_scans", check_runnie_scans, torch, peak, gen, libs)
    timed("time_traceback_floor", time_traceback_floor, torch)
    for r in rows:
        log("kernel " + json.dumps({
            "kernel": r["name"], "id": r["kid"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "max_abs_err": r["max_abs_err"],
        }))
    return rows


# -- phase 3: main paths -------------------------------------------------------

# model -> (long reads: count, min, max samples), (short reads: ...)
RUNS = {
    "r941_native": ((64, 95_000, 105_000), (16, 6_000, 12_800)),
    "r941_5mC": ((24, 40_000, 60_000), (8, 2_000, 5_000)),
}


def write_reads(np, rng, outdir: str, long: tuple, short: tuple) -> list:
    from flappie_tpu_torch.signal.fast5 import write_single_read_fast5
    from flappie_tpu_torch.signal.synthetic import synthetic_adc

    os.makedirs(outdir)
    sizes = []
    for count, lo, hi in (long, short):
        sizes += [int(n) for n in rng.integers(lo, hi, count)]
    names = []
    for k, n in enumerate(sizes):
        name = f"read{k:03d}.fast5"
        write_single_read_fast5(os.path.join(outdir, name), synthetic_adc(n, rng),
                                f"00000000-0000-4000-8000-{k:012d}")
        names.append((name, n))
    return names


def expected_programs(reads_dir: str, names: list, cfg) -> int:
    """Program dispatches the CLI's default settings give these reads:
    chunk batches of 256 chunks of 2560 blocks (2560 x the model's
    stride samples) across the long reads, plus bucket batches of at
    most 32 same-bucket short reads."""
    from flappie_tpu_torch.basecall import preprocess_batch
    from flappie_tpu_torch.signal.fast5 import read_raw

    t0 = time.perf_counter()
    pre = preprocess_batch([read_raw(os.path.join(reads_dir, n)) for n, _ in names])
    log(f"host: fast5 read + preprocessing of {len(names)} reads on one thread: "
        f"{time.perf_counter() - t0:.3f} s")
    return count_programs(pre, cfg)


def count_programs(pre: list, cfg, chunk: int = None) -> int:
    """expected_programs for preprocessed reads (RawTables); ``chunk``
    0 sends every read through the bucket programs (--chunk 0)."""
    from flappie_tpu_torch.basecall import bucket_length
    from flappie_tpu_torch.parallel.chunking import plan_chunks

    stride = cfg.total_stride
    chunk = 2560 * stride if chunk is None else chunk
    nchunk, buckets = 0, {}
    for rt in pre:
        L = rt.end - rt.start
        if chunk and L > chunk:
            nchunk += plan_chunks(L, stride, chunk, 1600).nchunk
        else:
            buckets[bucket_length(L)] = buckets.get(bucket_length(L), 0) + 1
    return -(-nchunk // 256) + sum(-(-c // 32) for c in buckets.values())


def parse_fastq(text: str, alphabet: str) -> dict:
    lines = text.splitlines()
    if len(lines) % 4:
        raise AssertionError("FASTQ: line count is not a multiple of 4")
    recs = {}
    for i in range(0, len(lines), 4):
        head, seq, plus, qual = lines[i : i + 4]
        if not head.startswith("@") or plus != "+" or len(seq) != len(qual) or not seq:
            raise AssertionError(f"malformed FASTQ record at line {i + 1}")
        if set(seq) - set(alphabet) or any(not 33 <= ord(c) <= 126 for c in qual):
            raise AssertionError(f"bad sequence or quality characters at line {i + 1}")
        meta = json.loads(head.split("  ", 1)[1])
        recs[meta["filename"]] = (seq, meta["normalised_score"], "\n".join(lines[i : i + 4]),
                                  meta)
    return recs


def identity(a: str, b: str, band: int = 256) -> float:
    """1 - edit distance / longer length (banded; exact for distances
    below the band)."""
    if a == b:
        return 1.0
    import numpy as np

    x, y = np.frombuffer(a.encode(), np.uint8), np.frombuffer(b.encode(), np.uint8)
    n, m = x.size, y.size
    big = n + m
    prev = np.arange(m + 1, dtype=np.int64)
    jj = np.arange(m + 1)
    for i in range(1, n + 1):
        cost = np.concatenate(([big], (y != x[i - 1]).astype(np.int64)))
        diag = np.concatenate(([big], prev[:-1])) + cost
        a_ = np.minimum(prev + 1, diag)
        a_[0] = i
        a_[np.abs(jj - i) > band] = big
        prev = np.minimum.accumulate(a_ - jj) + jj
    return 1.0 - prev[m] / max(n, m)


def time_chunk_program(torch, np, rng, card: str, cfg) -> None:
    """Device time of one full 256-chunk batch of the chunk program
    (the int16 wire, fb decode, 2560 blocks a chunk), outside the CLI,
    under the f32 stream and the bf16 stream (--fast) alternated."""
    from flappie_tpu_torch.basecall import (
        _device_basecall_chunk_packed_i16, pack_chunk_inputs_i16)
    from flappie_tpu_torch.models.network import stream_params
    from flappie_tpu_torch.models.params import init_synthetic, params_to_torch
    from flappie_tpu_torch.signal.synthetic import synthetic_adc

    params = params_to_torch(init_synthetic(cfg, seed=0), "cuda")
    params16 = stream_params(params, cfg, torch.bfloat16)
    CB, W = 256, 2560 * cfg.total_stride
    adc = np.stack([synthetic_adc(W, rng) for _ in range(CB)])
    pa = (adc.astype(np.float32) + np.float32(16.0)) * np.float32(1373.41 / 8192.0)
    med = np.median(pa, axis=1).astype(np.float32)
    mad = (np.median(np.abs(pa - med[:, None]), axis=1) * 1.4826).astype(np.float32)
    scal = np.stack([np.full(CB, 16.0), np.full(CB, 1373.41 / 8192.0), med, mad], 1)
    full = np.full(CB, W, np.int32)
    buf = torch.from_numpy(pack_chunk_inputs_i16(adc, full, np.full(CB, 1),
                                                 full // cfg.total_stride, scal))
    buf = buf.to("cuda")
    with torch.inference_mode():
        runs = alternated_ms(torch, {
            "f32": lambda: _device_basecall_chunk_packed_i16(params, buf, cfg, 1.0, False, False),
            "bf16": lambda: _device_basecall_chunk_packed_i16(
                params16, buf, cfg, 1.0, False, False, "auto", torch.bfloat16)},
            ALTERNATED_REPS)
    for stream, times in runs.items():
        ms = statistics.median(times)
        log(f"device {cfg.name}: chunk program, one batch of {CB} x {W} samples, {stream} "
            f"stream: {spread(times)} = {CB * W / ms / 1e3:.3f} Msamples/s device-only [{card}]")


def time_conv_stacks(torch, card: str, cfg) -> None:
    """Device time of the conv stack alone on one full chunk batch (256 x
    12800 samples, every read full) under each FLAPPIE_TPU_CONV_IMPL, and
    the pallas stack's two parts (pallas_stack_split)."""
    from flappie_tpu_torch.models.network import conv_stack
    from flappie_tpu_torch.models.params import init_synthetic, params_to_torch

    params = params_to_torch(init_synthetic(cfg, seed=0), "cuda")
    B, W = 256, 2560 * cfg.total_stride
    x = torch.randn(B, W, 1, device="cuda", generator=torch.Generator(device="cuda").manual_seed(3))
    lengths = torch.full((B,), W, dtype=torch.int32, device="cuda")
    times = {}
    with torch.inference_mode():
        for impl in ("xla", "fast", "pallas"):
            with knobs({"FLAPPIE_TPU_CONV_IMPL": impl}):
                times[impl] = cuda_ms(torch, lambda: conv_stack(params, cfg, x, lengths), 5)
        split = pallas_stack_split(torch, params, cfg, x, lengths)
    log(f"device {cfg.name}: conv stack alone on one batch of {B} x {W} samples, ms by "
        f"FLAPPIE_TPU_CONV_IMPL: {json.dumps(times)}; pallas split: {json.dumps(split)} "
        f"[{card}]")


def pallas_stack_split(torch, params, cfg, x, lengths) -> dict:
    """The conv stack under FLAPPIE_TPU_CONV_IMPL=pallas in its two parts
    (models/network.py _conv_stack_fast), each timed alone over 5 runs: K10
    (the 1->4->16 pair) and the rest, the strided conv (ops/conv.py
    conv1d_strided_ct, its im2col einsum and right-edge fix) with its
    activation and tail mask, on K10's output; each behind a device
    sleep."""
    from flappie_tpu_torch.models.network import ceil_div
    from flappie_tpu_torch.ops.activations import ACTIVATIONS
    from flappie_tpu_torch.ops.conv import conv1d_strided_ct
    from flappie_tpu_torch.ops.conv_cuda import conv12_fused
    from flappie_tpu_torch.ops.masking import mask_tail

    p0, p1, p2, c3 = params["conv0"], params["conv1"], params["conv2"], cfg.convs[2]

    def k10():
        return conv12_fused(x[..., 0], p0["W"], p0["b"], p1["W"], p1["b"], lengths)

    y2 = k10()

    def strided():
        y = ACTIVATIONS[c3.activation](conv1d_strided_ct(y2, p2["W"], p2["b"], c3.stride,
                                                         lengths))
        return mask_tail(y, ceil_div(lengths, c3.stride))

    return {"K10": cuda_ms(torch, k10, 5, lead=True),
            "strided conv": cuda_ms(torch, strided, 5, lead=True)}


def scan_path(torch, card: str, cfg) -> dict:
    """transitions(rnn_impl="scan") on one full-width chunk batch (256
    chunks of 2560 blocks, ragged lengths): exact launch counts (one K12
    a layer, K3 for the head's partition), transitions within 1e-4 of the
    fused path's, and the Viterbi paths over both equal.  Returns the
    scan run's counts."""
    from flappie_tpu_torch.models.network import transitions
    from flappie_tpu_torch.models.params import init_synthetic, params_to_torch
    from flappie_tpu_torch.ops.crf import crf_viterbi

    seq = {"lstm": "lstm_seq", "grumod": "grumod_seq"}[cfg.rnns[0].kind]
    params = params_to_torch(init_synthetic(cfg, seed=0), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(77)
    B, W = 256, 2560 * cfg.total_stride
    lengths = torch.randint(W // 2, W, (B,), generator=gen, device="cuda", dtype=torch.int32)
    lengths[0], lengths[1] = W, 3 * cfg.total_stride
    sig = torch.randn(B, W, generator=gen, device="cuda")
    with torch.inference_mode():
        fused, nb = transitions(params, cfg, sig, lengths)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan, nb2 = transitions(params, cfg, sig, lengths, rnn_impl="scan")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = check_counts(f"{cfg.name} transitions(rnn_impl='scan')",
                           {seq: len(cfg.rnns), "crf_sum_scan": 1})
        err = (scan - fused).abs().max().item()
        if not (torch.equal(nb, nb2) and err <= 1e-4):
            raise AssertionError(f"{cfg.name} scan path: max |scan - fused| {err} > 1e-4")
        path_f = crf_viterbi(fused, nb, cfg.nbase)[1]
        path_s = crf_viterbi(scan, nb, cfg.nbase)[1]
        ndiff = int((path_f != path_s).sum())
        nread = int((path_f != path_s).any(dim=1).sum())
    log(f"{cfg.name} transitions(rnn_impl='scan') on {B} x {W} samples: {wall * 1e3:.1f} ms "
        f"(host clock, synchronised), launches {json.dumps(got)}; max |scan - fused| "
        f"{err:.2e}; Viterbi paths differ in {ndiff} blocks of {nread} reads [{card}]")
    if ndiff:
        raise AssertionError(f"{cfg.name} scan path: Viterbi paths differ from the fused "
                             f"path's in {ndiff} blocks")
    return got


def device_time(prof):
    """(busy us, span us, kernel us by name) of the device events a
    torch.profiler run recorded, or None if it recorded none."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, end, by_name = 0.0, float("-inf"), {}
    for t0, t1, name in spans:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0)
    return busy, end - spans[0][0], by_name


def log_profile(what: str, prof, wall: float, card: str):
    """Logs the device busy share of ``wall`` and kernel time by name;
    returns the busy share, or None where no device event was recorded."""
    got = device_time(prof)
    if got is None:
        log(f"profile {what}: no device events recorded; device busy share not measured")
        return None
    busy, span, by_name = got
    log(f"profile {what}: wall {wall:.3f} s, device busy {busy / 1e6:.3f} s = "
        f"{100 * busy / 1e6 / wall:.1f}% of the wall, span of device work {span / 1e6:.3f} s "
        f"[{card}]")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    # the six longest, and every CRF decode kernel
    for name, us in ranked[:6] + [kv for kv in ranked[6:] if "crf_" in kv[0] or "Trace" in kv[0]]:
        log(f"  kernel time {us / 1e3:9.1f} ms  {name[:90]}")
    groups = "; ".join(f"{g} {ms:.3f} ms" for g, ms in group_ms(by_name).items() if ms)
    if groups:
        log(f"  kernel time by group: {groups}")
    return busy / 1e6 / wall


def profiled_run(torch, reads_dir: str, card: str, model: str):
    """The default run once more under torch.profiler (device activity
    only): the device busy share of the wall (returned; None where not
    measured), and kernel time by name."""
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(os.path.dirname(reads_dir), "gpu_fb_profiled.fastq")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = run_cli(torch, [reads_dir, "-o", out, "--model", model])
    return log_profile(f"{model} (fb run, profiler on)", prof, wall, card)


HOST_CALLS = 12


def profiled_host_calls(torch, reads_dir: str, card: str, model: str) -> None:
    """The default fb run once more under torch.profiler with host activity
    too: the operators and CUDA runtime calls that hold the host longest
    (self time), which name the call inside a phase where the host waits
    on the device."""
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(os.path.dirname(reads_dir), "gpu_fb_profiled_host.fastq")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run_cli(torch, [reads_dir, "-o", out, "--model", model])
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    log(f"profile {model} (fb run, host and device activity): wall {wall:.3f} s; the "
        f"{HOST_CALLS} host calls of the longest self time [{card}]")
    for e in rows[:HOST_CALLS]:
        log(f"  host self {e.self_cpu_time_total / 1e3:9.1f} ms  {e.count:7d} calls  {e.key[:80]}")


# the knobs at their defaults; every CLI run sets all of them
KNOBS = {"FLAPPIE_TPU_CRF_IMPL": "auto", "FLAPPIE_TPU_SCANB_FB": "split",
         "FLAPPIE_TPU_CONV_IMPL": "auto", "FLAPPIE_TPU_SCANB_KERNELS": "auto",
         "FLAPPIE_TPU_UPLOAD": "auto", "FLAPPIE_TPU_DISPATCH_GROUP": "1",
         "FLAPPIE_TPU_UPLOAD_THREADS": "0", "FLAPPIE_TPU_COLLECT_THREAD": "0",
         "FLAPPIE_TPU_PREPROCESS_WAVE": "16", "FLAPPIE_TPU_PREWARM": "0"}


@contextlib.contextmanager
def knobs(env=None):
    """KNOBS updated with ``env`` inside the block, as they were after it."""
    saved = {k: os.environ.get(k) for k in {**KNOBS, **(env or {})}}
    os.environ.update({**KNOBS, **(env or {})})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_cli(torch, args: list, main=None, env=None) -> float:
    """Wall seconds of one CLI call (flappie's unless ``main`` is given),
    the device synchronised at its end, under ``knobs(env)``."""
    if main is None:
        from flappie_tpu_torch.cli.flappie import main

    with knobs(env):
        t0 = time.perf_counter()
        rc = main(args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"CLI exited {rc} for {args}")
    return wall


def launch_counters() -> dict:
    """Every kernel wrapper's launch counter, by counter name."""
    from flappie_tpu_torch.ops import conv_cuda, crf_bm_cuda, crf_cuda, rnn_cuda

    return {
        "conv12": conv_cuda.conv12_fused,
        "lstm_seq": rnn_cuda.lstm_seq_cuda,
        "grumod_seq": rnn_cuda.grumod_seq_cuda,
        "lstm_layer": rnn_cuda.lstm_layer_tm,
        "lstm_layer_train": rnn_cuda.lstm_layer_tm_train,
        "grumod_layer": rnn_cuda.grumod_layer_tm,
        "lstm_layer_bf16": rnn_cuda.lstm_layer_tm_bf16,
        "grumod_layer_bf16": rnn_cuda.grumod_layer_tm_bf16,
        "lstm_layer_train_bf16": rnn_cuda.lstm_layer_tm_train_bf16,
        "lstm_layer_p1": rnn_cuda.lstm_layer_tm_p1,
        "lstm_layer_train_p1": rnn_cuda.lstm_layer_tm_train_p1,
        "grumod_layer_p1": rnn_cuda.grumod_layer_tm_p1,
        "lstm_layer_bf16_p1": rnn_cuda.lstm_layer_tm_bf16_p1,
        "lstm_layer_train_bf16_p1": rnn_cuda.lstm_layer_tm_train_bf16_p1,
        "grumod_layer_bf16_p1": rnn_cuda.grumod_layer_tm_bf16_p1,
        "lstm_layer_h3": rnn_cuda.lstm_layer_tm_h3,
        "lstm_layer_train_h3": rnn_cuda.lstm_layer_tm_train_h3,
        "grumod_layer_h3": rnn_cuda.grumod_layer_tm_h3,
        "lstm_layer_bf16_h3": rnn_cuda.lstm_layer_tm_bf16_h3,
        "lstm_layer_train_bf16_h3": rnn_cuda.lstm_layer_tm_train_bf16_h3,
        "grumod_layer_bf16_h3": rnn_cuda.grumod_layer_tm_bf16_h3,
        "affine_f32": rnn_cuda.affine_f32,
        "affine_bf16": rnn_cuda.affine_bf16,
        "affine_bf16_wmma": rnn_cuda.affine_bf16_wmma,
        "affine_bf16_f32": rnn_cuda.affine_bf16_f32,
        "crf_sum_scan": crf_bm_cuda.sum_states,
        "crf_fwdbwd": crf_bm_cuda.fwdbwd_states,
        "crf_viterbi": crf_bm_cuda.viterbi_fwd,
        "crf_traceback": crf_bm_cuda.traceback,
        "crf_bt_fwd": crf_cuda.fwd_scan,
        "crf_bt_viterbi": crf_cuda.viterbi_scan,
        "crf_bt_traceback": crf_cuda.traceback_bt,
    }


def counted_run(torch, what: str, args: list, want: dict, main=None, env=None):
    """One CLI run with every launch counter zeroed just before it and
    read just after; the counts must equal ``want`` (0 for every counter
    it leaves out).  ``env`` sets knobs for this run only (run_cli).
    Returns (wall, counts)."""
    zero_counts()
    wall = run_cli(torch, args, main, env)
    return wall, check_counts(what, want)


# the CRF kernels of a default fb program: K3 for the head's partition and
# K3/K4 for the posterior, K5, K6
FB_CRF = {"crf_sum_scan": 3, "crf_viterbi": 1, "crf_traceback": 1}
# the knob runs of each model's fb path: each setting and the kernel
# launches (other than the recurrent layers') it gives a program: K9 for
# the posterior's two scans; K11 for the head's partition and the whole
# decode; under the conv knob, K10 (pallas, stride-5 family) or none
KNOB_RUNS = {
    "r941_native": {
        "r941_native_fused": ({"FLAPPIE_TPU_SCANB_FB": "fused"},
                              {"crf_sum_scan": 1, "crf_fwdbwd": 1, "crf_viterbi": 1,
                               "crf_traceback": 1}),
        "r941_native_pallas": ({"FLAPPIE_TPU_CRF_IMPL": "pallas"},
                               {"crf_bt_fwd": 3, "crf_bt_viterbi": 1, "crf_bt_traceback": 1}),
        "r941_native_conv_fast": ({"FLAPPIE_TPU_CONV_IMPL": "fast"}, FB_CRF),
        "r941_native_conv_pallas": ({"FLAPPIE_TPU_CONV_IMPL": "pallas"},
                                    {**FB_CRF, "conv12": 1}),
    },
    "r941_5mC": {
        "r941_5mC_conv_pallas": ({"FLAPPIE_TPU_CONV_IMPL": "pallas"}, FB_CRF),
    },
}


def compare_fastq(what: str, got: dict, want: dict) -> None:
    """Every read within the GPU-vs-CPU band (identity >= 99.5%, |score
    delta| <= 1e-4) of ``want``; logs how many records are byte-equal."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: {len(got)} FASTQ records, expected {len(want)}")
    worst_id, worst_ds, same = 1.0, 0.0, 0
    for n in want:
        ident = identity(got[n][0], want[n][0])
        ds = abs(got[n][1] - want[n][1])
        same += got[n][2] == want[n][2]
        worst_id, worst_ds = min(worst_id, ident), max(worst_ds, ds)
        if not (ident >= 0.995 and ds <= 1e-4):
            raise AssertionError(f"{what} {n}: outside the band (identity {ident}, score "
                                 f"delta {ds})")
    log(f"{what}: {len(want)} reads, {same} records byte-equal, min identity "
        f"{worst_id:.6f}, max |score delta| {worst_ds:.2e}")


# -- phase 3, the trace file, the phase dump and the unchunked run -----------

# the model whose main path also runs --trace, FLAPPIE_TPU_PHASES and --chunk 0
TRACE_MODEL = "r941_native"
# the reads held to the CPU path under --chunk 0: two longer than the
# default chunk (12800 samples), whole through bucket 32768, and two short
UNCHUNKED_READS = ((2, 20_000, 32_000), (2, 3_000, 12_000))


@contextlib.contextmanager
def phases_to(path):
    """FLAPPIE_TPU_PHASES=path inside the block, the accounting reset as
    it starts (``path`` None: neither)."""
    from flappie_tpu_torch import timing

    if path is None:
        yield
        return
    timing.reset()
    os.environ["FLAPPIE_TPU_PHASES"] = path
    try:
        yield
    finally:
        os.environ.pop("FLAPPIE_TPU_PHASES", None)


def log_phases(what: str, path: str, wall: float, card: str) -> dict:
    """Logs the phase dump at ``path`` (each phase's wall and calls, the
    longest first) beside the run's wall; returns it."""
    with open(path) as fh:
        rep = json.load(fh)
    if not rep["phases"]:
        raise AssertionError(f"phases {what}: the dump at {path} names no phase")
    log(f"phases {what}: run wall {wall:.3f} s, process wall {rep['process_wall_s']:.3f} s since "
        f"the reset, accounted {rep['accounted_s']:.3f} s (phases nest and overlap) [{card}]")
    for k, v in rep["phases"].items():
        log(f"  phase {k:16s} {v['wall_s']:8.3f} s  {v['calls']:5d} calls")
    return rep


def trace_groups(path: str) -> dict:
    """The trace file read back as the card's host reads it: hdf5_min and
    trace_view.iter_traces -> {group: (signal, trace bytes)}."""
    import numpy as np

    from flappie_tpu_torch.cli import trace_view
    from flappie_tpu_torch.signal import hdf5_min

    root = hdf5_min.read(path)
    out = {}
    for read, sig, trace in trace_view.iter_traces(trace_view.MinFile(root), path, 0):
        raw = root.children[read].children["trace"].data
        if trace.shape != raw.shape or not np.array_equal(np.rint(trace * 255.0), raw):
            raise AssertionError(f"trace {read}: iter_traces does not give the stored bytes")
        out[read] = (sig, raw)
    if sorted(out) != sorted(root.children):
        raise AssertionError("trace: iter_traces skipped a group")
    return out


def trace_run(torch, card: str, cfg, reads_dir: str, names: list, fb_wall: float,
              want: dict) -> str:
    """The fb main path once more with --trace (and its phase dump): the
    FASTQ byte-equal to the run without it, one group a record in the file
    (read back through hdf5_min, as the card's host has no h5py), each
    with a float32 signal of the read's trimmed length and a uint8 trace
    of nblock + 1 rows of the model's states, each row after the first
    summing to 255 +- 4.  Returns the file's path."""
    from flappie_tpu_torch.basecall import preprocess_batch
    from flappie_tpu_torch.signal.fast5 import read_raw

    wdir = os.path.dirname(reads_dir)
    path = os.path.join(wdir, "gpu_trace.h5")
    out = os.path.join(wdir, "gpu_fb_trace.fastq")
    dump = os.path.join(wdir, "phases_trace.json")
    with phases_to(dump):
        wall, got = counted_run(torch, f"{cfg.name} fb --trace",
                                [reads_dir, "-o", out, "--model", cfg.name, "--trace", path], want)
    with open(out) as fh, open(os.path.join(wdir, "gpu_fb.fastq")) as fh2:
        text = fh.read()
        if text != fh2.read():
            raise AssertionError("--trace: the FASTQ differs from the run without --trace")
    recs = parse_fastq(text, "ACGTZ"[: cfg.nbase])
    t0 = time.perf_counter()
    groups = trace_groups(path)
    read_s = time.perf_counter() - t0
    pre = preprocess_batch([read_raw(os.path.join(reads_dir, n)) for n, _ in names])
    trimmed = {n: rt.end - rt.start for (n, _), rt in zip(names, pre)}
    if sorted(groups) != sorted(r[3]["uuid"] for r in recs.values()):
        raise AssertionError(f"--trace: {len(groups)} groups for {len(recs)} FASTQ records")
    worst = 0
    for fname, rec in recs.items():
        sig, trace = groups[rec[3]["uuid"]]
        nblock = rec[3]["nblock"]
        if sig.dtype != "float32" or sig.shape != (trimmed[fname],):
            raise AssertionError(f"--trace {fname}: signal {sig.dtype} {sig.shape}, expected "
                                 f"float32 ({trimmed[fname]},)")
        if trace.dtype != "uint8" or trace.shape != (nblock + 1, cfg.nstate):
            raise AssertionError(f"--trace {fname}: trace {trace.dtype} {trace.shape}, expected "
                                 f"uint8 ({nblock + 1}, {cfg.nstate})")
        dev = abs(trace[1:].astype(int).sum(axis=1) - 255).max()
        worst = max(worst, int(dev))
        if dev > 4:
            raise AssertionError(f"--trace {fname}: a trace row sums {dev} away from 255")
    nsample = sum(n for _, n in names)
    log(f"main path {cfg.name} fb --trace: {len(groups)} groups, file {os.path.getsize(path)} "
        f"bytes; wall {wall:.3f} s with --trace against {fb_wall:.3f} s without "
        f"({nsample / wall / 1e6:.3f} against {nsample / fb_wall / 1e6:.3f} Msamples/s); "
        f"FASTQ byte-equal to the run without --trace; every signal float32 of the trimmed "
        f"length, every trace uint8 [nblock + 1, {cfg.nstate}], rows after the first within "
        f"{worst} of 255; the file read back (hdf5_min, iter_traces) in {read_s:.3f} s; "
        f"launches {json.dumps(got)} [{card}]")
    log_phases(f"{cfg.name} fb --trace", dump, wall, card)
    return path


def compare_traces(gpu: str, cpu: str, reads: set, what: str = "gpu vs cpu",
                   same_groups: bool = False) -> None:
    """The card's trace file against the CPU path's (``what``: another
    pair) on the reads both ran (``cpu``'s groups; ``same_groups``: the
    first file's too): signals equal, traces within one count."""
    import numpy as np

    g, c = trace_groups(gpu), trace_groups(cpu)
    if set(c) != reads or not reads <= set(g) or (same_groups and set(g) != reads):
        raise AssertionError(f"{what} --trace: groups {sorted(g)} and {sorted(c)}, expected "
                             f"{sorted(reads)}")
    ndiff, nbytes = 0, 0
    for read in sorted(reads):
        (gs, gt), (cs, ct) = g[read], c[read]
        if not np.array_equal(gs, cs):
            raise AssertionError(f"trace {read}: the signal differs ({what})")
        if gt.shape != ct.shape:
            raise AssertionError(f"trace {read}: shapes {gt.shape} and {ct.shape} ({what})")
        d = np.abs(gt.astype(int) - ct.astype(int))
        if d.max() > 1:
            raise AssertionError(f"trace {read}: differs by more than one count ({what})")
        ndiff += int((d > 0).sum())
        nbytes += d.size
    log(f"trace {what} ({len(reads)} reads): signals equal, traces within one count, "
        f"{ndiff} of {nbytes} bytes differ by one")


def unchunked_run(torch, np, card: str, cfg, reads_dir: str, names: list, fb_wall: float):
    """--chunk 0: the main path's reads whole through the bucket programs
    (launch counts as those programs imply), then UNCHUNKED_READS on the
    card and on the port's CPU path, held to the GPU-vs-CPU band.
    Returns the main-path run's launch counts."""
    from flappie_tpu_torch.basecall import preprocess_batch
    from flappie_tpu_torch.signal.fast5 import read_raw

    layer = "lstm_layer"
    wdir = os.path.join(WORK, "unchunked")
    os.makedirs(wdir)

    def want(reads, dir_):
        P = count_programs(preprocess_batch([read_raw(os.path.join(dir_, n)) for n, _ in reads]),
                           cfg, chunk=0)
        return P, {layer: len(cfg.rnns) * P, **{k: n * P for k, n in FB_CRF.items()}}

    P, counts = want(names, reads_dir)
    out = os.path.join(wdir, "gpu_main.fastq")
    wall, got = counted_run(torch, f"{cfg.name} --chunk 0",
                            [reads_dir, "-o", out, "--chunk", "0"], counts)
    with open(out) as fh:
        recs = parse_fastq(fh.read(), "ACGT")
    if sorted(recs) != sorted(n for n, _ in names):
        raise AssertionError(f"--chunk 0: {len(recs)} FASTQ records for {len(names)} reads")
    nsample = sum(n for _, n in names)
    log(f"main path {cfg.name} fb --chunk 0: {len(recs)} reads, {P} bucket programs, wall "
        f"{wall:.3f} s ({nsample / wall / 1e6:.3f} Msamples/s; chunked {fb_wall:.3f} s), "
        f"launches {json.dumps(got)} [{card}]")

    small_dir = os.path.join(wdir, "small")
    small = write_reads(np, np.random.default_rng(20261019), small_dir, *UNCHUNKED_READS)
    Ps, counts = want(small, small_dir)
    gpu_out, cpu_out = os.path.join(wdir, "gpu_small.fastq"), os.path.join(wdir, "cpu_small.fastq")
    gpu_wall, got_small = counted_run(torch, f"{cfg.name} --chunk 0 (held to the CPU)",
                                      [small_dir, "-o", gpu_out, "--chunk", "0"], counts)
    cpu_wall = run_cli(torch, [small_dir, "-o", cpu_out, "--chunk", "0", "--device", "cpu"])
    with open(gpu_out) as fh, open(cpu_out) as fh2:
        compare_fastq(f"gpu vs cpu {cfg.name} --chunk 0 ({[n for _, n in small]} samples, {Ps} "
                      f"programs; gpu wall {gpu_wall:.3f} s, cpu wall {cpu_wall:.1f} s)",
                      parse_fastq(fh.read(), "ACGT"), parse_fastq(fh2.read(), "ACGT"))
    log(f"--chunk 0 (held to the CPU) launches {json.dumps(got_small)}")
    return got


def main_path(torch, np, card: str, model: str) -> dict:
    """One model's main path in fb and --viterbi (for r941_native also fb
    under each knob of KNOB_RUNS, held to the default fb run); returns
    the fb runs' launch counts by run name."""
    from flappie_tpu_torch.models.config import get_model_config

    cfg = get_model_config(model)
    layer = {"lstm": "lstm_layer", "grumod": "grumod_layer"}[cfg.rnns[0].kind]
    alphabet = "ACGTZ"[: cfg.nbase]
    wdir = os.path.join(WORK, model)
    reads_dir = os.path.join(wdir, "reads")
    rng = np.random.default_rng(20261016)
    names = write_reads(np, rng, reads_dir, *RUNS[model])
    nsample = sum(n for _, n in names)
    P = expected_programs(reads_dir, names, cfg)
    log(f"main path {model}: {len(names)} reads, {nsample} samples, {P} programs per run")

    launches = {}
    outputs = {}
    walls = {}
    traced = model == TRACE_MODEL  # the trace file, the phase dump, --chunk 0
    for mode, extra in (("fb", []), ("viterbi", ["--viterbi"])):
        out = os.path.join(wdir, f"gpu_{mode}.fastq")
        want = {layer: len(cfg.rnns) * P, **{k: n * P for k, n in FB_CRF.items()}}
        if mode == "viterbi":
            want["crf_sum_scan"] = P
        dump = os.path.join(wdir, "phases_fb.json") if traced and mode == "fb" else None
        with phases_to(dump):
            wall, got = counted_run(torch, f"{model} {mode}",
                                    [reads_dir, "-o", out, "--model", model] + extra, want)
        walls[mode] = wall
        with open(out) as fh:
            recs = parse_fastq(fh.read(), alphabet)
        if sorted(recs) != sorted(n for n, _ in names):
            raise AssertionError(f"{model} {mode}: {len(recs)} FASTQ records for "
                                 f"{len(names)} reads")
        outputs[mode] = recs
        if mode == "fb":
            launches[model] = got
        log(f"main path {model} {mode}: {len(recs)} reads, wall {wall:.3f} s, "
            f"{nsample / wall / 1e6:.3f} Msamples/s, launches {json.dumps(got)} [{card}]")
        if dump:
            fb_phases = log_phases(f"{model} fb", dump, wall, card)
            gpu_trace = trace_run(torch, card, cfg, reads_dir, names, walls["fb"], want)

    for run, (env, per_program) in KNOB_RUNS[model].items():
        out = os.path.join(wdir, f"gpu_{run}.fastq")
        want = {layer: len(cfg.rnns) * P, **{k: n * P for k, n in per_program.items()}}
        wall, got = counted_run(torch, run, [reads_dir, "-o", out, "--model", model], want,
                                env=env)
        launches[run] = got
        with open(out) as fh:
            compare_fastq(f"{run} fb vs the default fb run", parse_fastq(fh.read(), alphabet),
                          outputs["fb"])
        log(f"main path {run} ({json.dumps(env)}) fb: wall {wall:.3f} s, "
            f"{nsample / wall / 1e6:.3f} Msamples/s, launches {json.dumps(got)} [{card}]")

    # a subset against the port's own CPU path
    subset = [names[0][0], names[1][0], names[-2][0], names[-1][0]]
    sub_dir = os.path.join(wdir, "subset")
    os.makedirs(sub_dir)
    for n in subset:
        shutil.copy(os.path.join(reads_dir, n), sub_dir)
    cpu_out = os.path.join(wdir, "cpu_fb.fastq")
    cpu_trace = os.path.join(wdir, "cpu_trace.h5")
    cpu_wall = run_cli(torch, [sub_dir, "-o", cpu_out, "--model", model, "--device", "cpu"]
                       + (["--trace", cpu_trace] if traced else []))
    with open(cpu_out) as fh:
        cpu = parse_fastq(fh.read(), alphabet)
    compare_fastq(f"gpu vs cpu {model} (cpu wall {cpu_wall:.1f} s)",
                  {n: outputs["fb"][n] for n in subset}, cpu)
    if traced:
        compare_traces(gpu_trace, cpu_trace, {outputs["fb"][n][3]["uuid"] for n in subset})
        launches[f"{model}_unchunked"] = unchunked_run(torch, np, card, cfg, reads_dir, names,
                                                       walls["fb"])
    time_chunk_program(torch, np, rng, card, cfg)
    if len(cfg.convs) == 3:
        time_conv_stacks(torch, card, cfg)
    launches[f"{model}_scan"] = scan_path(torch, card, cfg)
    busy = profiled_run(torch, reads_dir, card, model)
    if traced:
        profiled_host_calls(torch, reads_dir, card, model)
        share = "not measured" if busy is None else f"{100 * busy:.1f}%"
        log(f"host phases of the {model} fb run (wall {walls['fb']:.3f} s) beside the device "
            f"busy share of its profiled run ({share}): " + "; ".join(
                f"{k} {v['wall_s']:.3f} s = {100 * v['wall_s'] / walls['fb']:.1f}%"
                for k, v in fb_phases["phases"].items()) + f" [{card}]")
    return launches


# -- phase 3, the server -------------------------------------------------------

# each request directory: 6 reads that are chunked and 4 for the buckets
SERVE_READS = ((6, 30_000, 60_000), (4, 3_000, 12_000))
# the multi-read file of the watch run: reads of the same two kinds
# (at most 8: hdf5_min's writer keeps a group to one symbol-table node)
SERVE_MULTI = ((3, 30_000, 60_000), (3, 3_000, 12_000))
SERVE_QCAL = "1.1:-0.5"


class _Tee:
    """sys.stderr's stand-in: writes through and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.buf = stream, []

    def write(self, text):
        self.buf.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.buf)


class _Requests:
    """sys.stdin's stand-in for serve_stdin: yields the request lines and
    notes, as each is taken (so after the one before it has been served),
    where stdout and the acks stood and the host clock."""

    def __init__(self, requests, out, err):
        self.requests, self.out, self.err = requests, out, err
        self.marks = []

    def __iter__(self):
        for request in self.requests:
            self.marks.append((self.out.tell(), len(self.err.text()), time.perf_counter()))
            yield request + "\n"
        self.marks.append((self.out.tell(), len(self.err.text()), time.perf_counter()))


@contextlib.contextmanager
def captured_stderr():
    tee = _Tee(sys.stderr)
    sys.stderr = tee
    try:
        yield tee
    finally:
        sys.stderr = tee.stream


def write_multi_read(np, rng, path: str) -> list:
    """A multi-read fast5 of SERVE_MULTI's reads, written as an hdf5_min
    tree (the card's machine has no h5py); returns the read ids."""
    from flappie_tpu_torch.signal import hdf5_min
    from flappie_tpu_torch.signal.synthetic import synthetic_adc

    channel = {"digitisation": 8192.0, "offset": 16.0, "range": 1373.41, "sampling_rate": 4000.0}
    sizes = [int(n) for count, lo, hi in SERVE_MULTI for n in rng.integers(lo, hi, count)]
    groups = {}
    for k, n in enumerate(sizes):
        uuid = f"00000000-0000-4000-9000-{k:012d}"
        groups[f"read_{uuid}"] = hdf5_min.Node(children={
            "Raw": hdf5_min.Node(attrs={"read_id": np.bytes_(uuid)}, children={
                "Signal": hdf5_min.Node(data=synthetic_adc(n, rng))}),
            "channel_id": hdf5_min.Node(attrs={k: np.float64(v) for k, v in channel.items()}),
        })
    hdf5_min.write(path, hdf5_min.Node(attrs={"file_version": np.bytes_("2.0")},
                                       children=groups))
    return sorted(g[len("read_"):] for g in groups)


def serve_args(extra: list):
    from flappie_tpu_torch.cli import serve

    return serve.build_parser().parse_args(["--model", "r941_native"] + extra)


def serve_counts(programs: int) -> dict:
    return {"lstm_layer": 5 * programs, **{k: n * programs for k, n in FB_CRF.items()}}


def serve_stdin_run(torch, np, card: str) -> None:
    """flappie-serve's stdin mode at full width, through serve.main with
    --warmup and FLAPPIE_TPU_PHASES: a warm server answers a directory, a
    missing path, the same directory again and a second directory; each
    request's FASTQ bytes equal the flappie CLI's on the same files (in
    this process, and in a fresh process for the first); the launch
    counts of the warmup and the four requests equal what their programs
    imply; the server dumps its phases at exit."""
    from flappie_tpu_torch.cli import serve
    from flappie_tpu_torch.models.config import get_model_config

    cfg = get_model_config("r941_native")
    wdir = os.path.join(WORK, "serve")
    rng = np.random.default_rng(20261017)
    dirs = [os.path.join(wdir, f"run{k}") for k in (1, 2)]
    names = [write_reads(np, rng, d, *SERVE_READS) for d in dirs]
    programs = [expected_programs(d, n, cfg) for d, n in zip(dirs, names)]
    missing = os.path.join(wdir, "missing")
    requests = [dirs[0], missing, dirs[0], dirs[1]]
    nsample = [sum(n for _, n in names[k]) for k in (0, 0, 0, 1)]

    out = io.StringIO()
    saved_in = sys.stdin
    dump = os.path.join(wdir, "phases_serve.json")
    with captured_stderr() as err, contextlib.redirect_stdout(out), phases_to(dump):
        sys.stdin = feed = _Requests(requests, out, err)
        try:
            zero_counts()
            t0 = time.perf_counter()
            rc = serve.main(["--model", "r941_native", "--warmup"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            # the warmup: one read one sample past the chunk, one chunk program
            counts = check_counts("serve stdin",
                                  serve_counts(1 + 2 * programs[0] + programs[1]))
        finally:
            sys.stdin = saved_in
    if rc != 0:
        raise AssertionError(f"serve.main returned {rc}")
    ready = feed.marks[0][2] - t0
    log(f"serve: Server() and --warmup {ready:.3f} s to the first request (weights uploaded, "
        f"one synthetic read of {2560 * cfg.total_stride + 211} samples through the chunk "
        f"program; the kernels were built and loaded by the phases before) [{card}]")
    text, acks = out.getvalue(), err.text()
    if acks.count("flappie-serve: ready") != 1:
        raise AssertionError("serve: no single ready ack")
    got, walls, clock = [], [], []
    for k, request in enumerate(requests):
        (o0, e0, t0), (o1, e1, t1) = feed.marks[k], feed.marks[k + 1]
        got.append(text[o0:o1])
        clock.append(t1 - t0)
        ack = [a for a in acks[e0:e1].splitlines() if a.startswith("flappie-serve: ")]
        n = len(names[1 if k == 3 else 0]) if k != 1 else 0
        want = f"flappie-serve: done {request} reads={n} called={n} wall="
        if len(ack) != 1 or not ack[0].startswith(want):
            raise AssertionError(f"serve request {k + 1}: acks {ack}, expected '{want}...'")
        walls.append(float(ack[0].split("wall=")[1].rstrip("s")))
    if got[1] != "" or got[2] != got[0]:
        raise AssertionError("serve: the missing path gave records, or the repeat request's "
                             "FASTQ differs from the first's")
    for k in (0, 3):
        parse_fastq(got[k], "ACGT")
        cli_out = os.path.join(wdir, f"cli_run{1 + k // 3}.fastq")
        run_cli(torch, [requests[k], "-o", cli_out])
        with open(cli_out) as fh:
            if fh.read() != got[k]:
                raise AssertionError(f"serve request {k + 1}: FASTQ differs from the CLI's")
    fresh = os.path.join(wdir, "cli_fresh.fastq")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "flappie_tpu_torch.cli.flappie", dirs[0], "-o", fresh],
                   cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE), check=True, timeout=600)
    cold = time.perf_counter() - t0
    with open(fresh) as fh:
        if fh.read() != got[0]:
            raise AssertionError("serve request 1: FASTQ differs from a fresh CLI process's")
    log(f"serve stdin: 4 requests; request 1 ({nsample[0]} samples, {programs[0]} programs) "
        f"{clock[0]:.4f} s (ack wall={walls[0]:.2f}s), requests 2-4 {clock[1]:.4f} / "
        f"{clock[2]:.4f} / {clock[3]:.4f} s (ack {walls[1]:.2f} / {walls[2]:.2f} / "
        f"{walls[3]:.2f}; the missing path; the repeat; the second directory, {nsample[3]} "
        f"samples, {programs[1]} programs), {nsample[0] / clock[0] / 1e6:.3f} and "
        f"{nsample[3] / clock[3] / 1e6:.3f} Msamples/s for requests 1 and 4; a fresh CLI "
        f"process on request 1's files {cold:.3f} s; every FASTQ byte-equal to the CLI's, the "
        f"repeat to the first, the missing path acked with reads=0 [{card}]")
    log(f"serve stdin launches: {json.dumps(counts)} (the warmup's 1 + {programs[0]} + "
        f"{programs[0]} + {programs[1]} programs)")
    log_phases("flappie-serve (the warmup and 4 requests, dumped at server exit)", dump, wall,
               card)


def serve_watch_run(torch, np, card: str) -> None:
    """flappie-serve's watch mode (--multi --qcal --output-dir): a
    multi-read file dropped into the watched directory is published once,
    its records the CLI's --multi records with calibrated qualities; a
    STOP file ends the server; its launch counts are checked."""
    import threading

    from flappie_tpu_torch.basecall import preprocess_batch
    from flappie_tpu_torch.cli import serve
    from flappie_tpu_torch.models.config import get_model_config
    from flappie_tpu_torch.qcal import apply_calibration, parse_qcal
    from flappie_tpu_torch.signal.fast5 import iter_reads

    cfg = get_model_config("r941_native")
    wdir = os.path.join(WORK, "serve_watch")
    watch, outdir = os.path.join(wdir, "in"), os.path.join(wdir, "out")
    os.makedirs(watch)
    multi = os.path.join(wdir, "multi.fast5")
    ids = write_multi_read(np, np.random.default_rng(20261018), multi)
    programs = count_programs(preprocess_batch(list(iter_reads(multi))), cfg)
    server = serve.Server(serve_args(["--watch", watch, "--multi", "--qcal", SERVE_QCAL,
                                      "--output-dir", outdir, "--poll", "0.2"]))
    rc = []
    with captured_stderr() as err:
        zero_counts()
        th = threading.Thread(target=lambda: rc.append(serve.serve_watch(server)))
        th.start()
        try:
            t0 = time.perf_counter()
            shutil.copy(multi, os.path.join(watch, ".multi.fast5.part"))
            os.replace(os.path.join(watch, ".multi.fast5.part"),
                       os.path.join(watch, "multi.fast5"))
            while " done " not in err.text() and time.perf_counter() - t0 < 300 and th.is_alive():
                time.sleep(0.05)
            landed = time.perf_counter() - t0
        finally:
            with open(os.path.join(watch, "STOP"), "w"):
                pass
            th.join(timeout=60)
        torch.cuda.synchronize()
        counts = check_counts("serve watch", serve_counts(programs))
    acks = [a for a in err.text().splitlines() if a.startswith("flappie-serve: ")]
    dest = os.path.join(outdir, "multi.fastq")
    want_ack = f"flappie-serve: done {os.path.join(watch, 'multi.fast5')} reads={len(ids)} " \
               f"called={len(ids)} wall="
    if th.is_alive() or rc != [0] or len(acks) != 2 or not acks[0].startswith(want_ack) \
            or acks[1] != "flappie-serve: stopping (stop file present)" \
            or sorted(os.listdir(outdir)) != ["multi.fastq"]:
        raise AssertionError(f"serve watch: rc {rc}, acks {acks}, published "
                             f"{sorted(os.listdir(outdir)) if os.path.isdir(outdir) else None}")
    cli_out = os.path.join(wdir, "cli_multi.fastq")
    run_cli(torch, [multi, "--multi", "-o", cli_out])
    with open(cli_out) as fh:
        plain = fh.read().splitlines()
    with open(dest) as fh:
        got = fh.read().splitlines()
    a, b = parse_qcal(SERVE_QCAL)
    want = [apply_calibration(line, a, b) if i % 4 == 3 else line for i, line in enumerate(plain)]
    if got != want or [h.split()[0][1:] for h in got[::4]] != ids:
        raise AssertionError("serve watch: the published records are not the CLI's --multi "
                             "records with calibrated qualities")
    moved = sum(x != y for q, p in zip(got[3::4], plain[3::4]) for x, y in zip(q, p))
    log(f"serve watch: {len(ids)} reads of a multi-read file published once in {landed:.2f} s "
        f"from the drop ({acks[0].split('wall=')[1].split()[0]} of basecalling), equal to the "
        f"CLI's --multi records with --qcal {SERVE_QCAL} applied ({moved} of "
        f"{sum(map(len, plain[3::4]))} quality bytes moved); launches {json.dumps(counts)} "
        f"({programs} programs) [{card}]")


# runnie's reads: 32 of 20k-60k samples (buckets 32768 and 65536, up to
# ~13.1k blocks a read) and 8 of 3k-12k
RUNNIE_READS = ((32, 20_000, 60_000), (8, 3_000, 12_000))


def runnie_buckets(reads_dir: str, names: list) -> tuple:
    """(programs, each read's bucket): runnie runs batches of at most 32
    same-bucket reads (no chunking)."""
    from flappie_tpu_torch.basecall import bucket_length, preprocess_batch
    from flappie_tpu_torch.signal.fast5 import read_raw

    of = [bucket_length(rt.end - rt.start) for rt in preprocess_batch(
        [read_raw(os.path.join(reads_dir, n)) for n, _ in names])]
    counts = {b: of.count(b) for b in sorted(set(of))}
    log(f"runnie buckets (samples: reads): {json.dumps(counts)}")
    return sum(-(-c // 32) for c in counts.values()), of


def parse_run(text: str) -> dict:
    """.run text -> {uuid: [(base, shape, scale, dwell) line, ...]}."""
    recs, cur = {}, None
    for line in text.splitlines():
        if line.startswith("# "):
            cur = recs.setdefault(line[2:], [])
        else:
            f = line.split("\t")
            if cur is None or len(f) != 4 or f[0] not in "ACGT" or not f[3].isdigit():
                raise AssertionError(f"malformed .run line {line!r}")
            cur.append(line)
    return recs


def compare_runs(what: str, got: dict, want: dict, loose: bool = False) -> None:
    """Records equal line for line, or base and dwell equal with shape
    and scale within 2e-5; logs the count of lines that differ.  With
    ``loose`` (records decoded from transitions that differ in their last
    bits, where runnie's fb decode follows near ties) every record is held
    instead by its run bases' identity (>= 99%) and its run count (within
    1%)."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: {len(got)} .run records, expected {len(want)}")
    if loose:
        worst, nsame = 1.0, 0
        for uuid, b in want.items():
            a = got[uuid]
            ident = identity("".join(x[0] for x in a), "".join(x[0] for x in b))
            worst, nsame = min(worst, ident), nsame + (a == b)
            if not (ident >= 0.99 and abs(len(a) - len(b)) <= 0.01 * len(b)):
                raise AssertionError(f"{what} {uuid}: {len(a)} runs against {len(b)}, run "
                                     f"bases' identity {ident}")
        log(f"{what}: {len(want)} records held by their run bases, {nsame} equal line for "
            f"line, min identity {worst:.6f}")
        return
    nline = ndiff = 0
    for uuid, lines in want.items():
        if len(got[uuid]) != len(lines):
            raise AssertionError(f"{what} {uuid}: {len(got[uuid])} runs, expected {len(lines)}")
        for a, b in zip(got[uuid], lines):
            nline += 1
            if a == b:
                continue
            ndiff += 1
            fa, fb = a.split("\t"), b.split("\t")
            if (fa[0], fa[3]) != (fb[0], fb[3]) or any(
                    abs(float(fa[i]) - float(fb[i])) > 2e-5 for i in (1, 2)):
                raise AssertionError(f"{what} {uuid}: {a!r} against {b!r}")
    log(f"{what}: {len(want)} records, {nline} lines, {ndiff} differ in a shape or scale "
        "digit (within 2e-5)")


def hold_heaviest_program(torch, reads_dir: str, names: list, bucket_of: list) -> None:
    """runnie's heaviest program on its own reads (its largest bucket:
    RUNNIE_SCAN_SHAPE), the network on the card, then under each impl the
    decode on the card (kernels) and on the CPU (plain versions) from the
    same transitions: --viterbi paths bit-equal; fb posteriors finite and
    the Viterbi over the card's posterior bit-equal.  The sum scans are
    held to their plain versions on one device by check_runnie_scans;
    here the card's and the CPU's exp and log round apart over 13k
    blocks of normalised weights by more than a relative bound of the
    states allows, so their max |card - CPU| is logged beside max |state|
    with the blocks where the CPU's own fb decode takes another path: near
    ties those last bits decide, at most 1% of the blocks."""
    from flappie_tpu_torch.basecall import _unpack_i16, pack_bucket, preprocess_batch
    from flappie_tpu_torch.decode.runlength import rle_split, rle_transpost, rle_viterbi
    from flappie_tpu_torch.models.config import get_model_config
    from flappie_tpu_torch.models.network import transitions
    from flappie_tpu_torch.models.params import init_synthetic, params_to_torch
    from flappie_tpu_torch.ops.crf import crf_backward, crf_forward, rle_index
    from flappie_tpu_torch.signal.fast5 import read_raw

    cfg = get_model_config("rle_r941_native")
    bucket = max(bucket_of)
    sel = [n for (n, _), b in zip(names, bucket_of) if b == bucket]
    pre = preprocess_batch([read_raw(os.path.join(reads_dir, n)) for n in sel])
    _, buf = pack_bucket(list(enumerate(pre)), bucket)
    params = params_to_torch(init_synthetic(cfg, seed=0), "cuda")
    with torch.inference_mode():
        sig, lengths, _, _ = _unpack_i16(torch.from_numpy(buf).to("cuda"))
        out, nblocks = transitions(params, cfg, sig, lengths, 1.0)
        with knobs({"FLAPPIE_TPU_CONV_IMPL": "pallas"}):
            conv_err = (transitions(params, cfg, sig, lengths, 1.0)[0] - out).abs().max().item()
    if not conv_err <= 1e-4:
        raise AssertionError(f"runnie's bucket-{bucket} program: transitions under "
                             f"FLAPPIE_TPU_CONV_IMPL=pallas off the default's by {conv_err}")
    log(f"runnie's bucket-{bucket} program: max |transitions under conv pallas - default| "
        f"{conv_err:.2e}")
    B, T, _ = out.shape
    if (T, B) != RUNNIE_SCAN_SHAPE:
        raise AssertionError(f"runnie's bucket-{bucket} program: T={T}, B={B}, expected "
                             f"{RUNNIE_SCAN_SHAPE}")
    out_c, nb_c = out.cpu(), nblocks.cpu()
    valid = torch.arange(T)[None, :] < nb_c[:, None]
    what = f"runnie bucket-{bucket} program (T={T}, B={B}, {int(nb_c.sum())} blocks)"
    idx = rle_index(cfg.nbase)
    scans = {"alphas": lambda t, n: crf_forward(t, n, cfg.nbase, idx=idx)[0],
             "betas": lambda t, n: crf_backward(t, n, cfg.nbase, idx=idx)}
    for impl in ("scanb", "pallas"):
        with knobs({"FLAPPIE_TPU_CRF_IMPL": impl}), torch.inference_mode():
            t0 = time.perf_counter()
            if not torch.equal(rle_viterbi(out, nblocks, cfg.nbase)[1].cpu(),
                               rle_viterbi(out_c, nb_c, cfg.nbase)[1]):
                raise AssertionError(f"{what} {impl} --viterbi: card path is not the CPU's")
            errs = {}
            for name, scan in scans.items():
                want = scan(rle_split(out_c, cfg.nbase)[2], nb_c)
                errs[name] = [(scan(rle_split(out, cfg.nbase)[2], nblocks).cpu() - want).abs()
                              .max().item(), want.abs().max().item()]
            post_g = rle_transpost(out, nblocks, cfg.nbase)
            post, post_c = post_g.cpu(), rle_transpost(out_c, nb_c, cfg.nbase)
            if not bool(torch.isfinite(post).all()):
                raise AssertionError(f"{what} {impl} fb: a posterior value is not finite")
            errs["posterior"] = [
                torch.where(valid[..., None], (post - post_c).abs(), 0.0).max().item(),
                torch.where(valid[..., None], post_c.abs(), 0.0).max().item()]
            path = rle_viterbi(post_g, nblocks, cfg.nbase)[1].cpu()
            if not torch.equal(path, rle_viterbi(post, nb_c, cfg.nbase)[1]):
                raise AssertionError(f"{what} {impl} fb: the card's Viterbi over its posterior "
                                     "is not the CPU's")
            path_c = rle_viterbi(post_c, nb_c, cfg.nbase)[1]
            flips = int(((path != path_c) & valid).sum())
            if flips > 0.01 * int(valid.sum()):
                raise AssertionError(f"{what} {impl} fb: the CPU's own decode takes another "
                                     f"path in {flips} blocks, more than 1% (not near ties)")
        log(f"{what}, {impl}: card and CPU decodes of the same transitions: --viterbi paths "
            f"equal; fb [max |card - CPU|, max |CPU|] {json.dumps(errs)}, the Viterbi over the "
            f"card's posterior equal; {flips} blocks where the CPU's own fb decode takes "
            f"another path ({time.perf_counter() - t0:.1f} s)")


def runnie_path(torch, np, card: str) -> dict:
    """rle_r941_native through flappie_tpu_torch.cli.runnie.main at full
    width, fb and --viterbi, each under the default CRF impl and under
    FLAPPIE_TPU_CRF_IMPL=pallas, exact launch counts; the .run bytes of
    the two impls held to each other, the decode of the heaviest program
    and 4 short reads to the port's CPU path.  Returns the pallas fb
    run's launch counts."""
    from flappie_tpu_torch.cli.runnie import main as runnie_main
    from flappie_tpu_torch.models.config import get_model_config

    cfg = get_model_config("rle_r941_native")
    wdir, reads_dir, names = write_runnie_reads(np)
    nsample = sum(n for _, n in names)
    uuids = sorted(f"00000000-0000-4000-8000-{k:012d}" for k in range(len(names)))
    P, bucket_of = runnie_buckets(reads_dir, names)
    log(f"main path rle_r941_native (runnie): {len(names)} reads, {nsample} samples, "
        f"{P} programs per run")
    L = len(cfg.rnns) * P
    want = {
        ("fb", "scanb"): {"crf_sum_scan": 3 * P, "crf_viterbi": P, "crf_traceback": P},
        ("viterbi", "scanb"): {"crf_sum_scan": P, "crf_viterbi": P, "crf_traceback": P},
        ("fb", "pallas"): {"crf_bt_fwd": 3 * P, "crf_bt_viterbi": P, "crf_bt_traceback": P},
        ("viterbi", "pallas"): {"crf_bt_fwd": P, "crf_bt_viterbi": P, "crf_bt_traceback": P},
    }
    outputs, launches = {}, {}
    for (mode, impl), counts in want.items():
        out = os.path.join(wdir, f"gpu_{mode}_{impl}.run")
        args = [reads_dir, "-o", out] + (["--viterbi"] if mode == "viterbi" else [])
        wall, got = counted_run(torch, f"runnie {mode} {impl}", args,
                                {"lstm_layer": L, **counts}, runnie_main,
                                {"FLAPPIE_TPU_CRF_IMPL": impl})
        with open(out) as fh:
            recs = parse_run(fh.read())
        if sorted(recs) != uuids:
            raise AssertionError(f"runnie {mode} {impl}: {len(recs)} records for "
                                 f"{len(names)} reads")
        outputs[mode, impl] = recs
        launches[mode, impl] = got
        log(f"main path rle_r941_native {mode} {impl}: {len(recs)} reads, wall {wall:.3f} s, "
            f"{nsample / wall / 1e6:.3f} Msamples/s, launches {json.dumps(got)} [{card}]")
    for mode in ("fb", "viterbi"):
        compare_runs(f"runnie {mode}: pallas vs scanb", outputs[mode, "pallas"],
                     outputs[mode, "scanb"])
    # fb once more under the conv knob: K10 once a program
    out = os.path.join(wdir, "gpu_fb_conv_pallas.run")
    wall, got = counted_run(torch, "runnie fb conv pallas", [reads_dir, "-o", out],
                            {"lstm_layer": L, **want["fb", "scanb"], "conv12": P}, runnie_main,
                            {"FLAPPIE_TPU_CONV_IMPL": "pallas"})
    with open(out) as fh:
        compare_runs("runnie fb: FLAPPIE_TPU_CONV_IMPL=pallas vs the default",
                     parse_run(fh.read()), outputs["fb", "scanb"],
                     loose=True)
    log(f"main path rle_r941_native fb under FLAPPIE_TPU_CONV_IMPL=pallas: wall {wall:.3f} s, "
        f"{nsample / wall / 1e6:.3f} Msamples/s, launches {json.dumps(got)} [{card}]")

    hold_heaviest_program(torch, reads_dir, names, bucket_of)

    sub_dir = os.path.join(wdir, "subset")
    os.makedirs(sub_dir)
    subset = [k for k, (_, n) in enumerate(names) if n < 12_000][:4]
    for k in subset:
        shutil.copy(os.path.join(reads_dir, names[k][0]), sub_dir)
    cpu_out = os.path.join(wdir, "cpu_fb.run")
    cpu_wall = run_cli(torch, [sub_dir, "-o", cpu_out, "--device", "cpu"], runnie_main)
    with open(cpu_out) as fh:
        cpu = parse_run(fh.read())
    compare_runs(f"runnie gpu vs cpu, fb ({len(subset)} reads, cpu wall {cpu_wall:.1f} s)",
                 {u: outputs["fb", "scanb"][u] for u in cpu}, cpu)

    profiled_runnie(torch, reads_dir, card)
    profiled_runnie(torch, reads_dir, card, {"FLAPPIE_TPU_CRF_IMPL": "pallas"})
    return launches["fb", "pallas"]


def write_runnie_reads(np) -> tuple:
    """runnie's reads (RUNNIE_READS, seeded) under WORK: (work directory,
    reads directory, [(file, samples)])."""
    wdir = os.path.join(WORK, "rle_r941_native")
    reads_dir = os.path.join(wdir, "reads")
    return wdir, reads_dir, write_reads(np, np.random.default_rng(20261017), reads_dir,
                                        *RUNNIE_READS)


# kernel names of a profile by group (this checkout's and an earlier one's)
KERNEL_GROUPS = {
    "K11 forward + Viterbi": ("crf_bt_fwd", "crf_bt_viterbi"),
    "K6": ("BmTrace", "crf_traceback_kernel"),
    "K11 traceback": ("BtTrace", "crf_bt_traceback_kernel"),
}
# replays of a run's tracebacks under the profiler (traceback_glue)
GLUE_REPS = 5


def group_ms(by_name: dict) -> dict:
    """Device ms of each KERNEL_GROUPS group in a profile's {name: us}."""
    return {g: sum(us for name, us in by_name.items() if any(p in name for p in parts)) / 1e3
            for g, parts in KERNEL_GROUPS.items()}


@contextlib.contextmanager
def captured_tracebacks():
    """Inside the block every ops/crf.py viterbi_traceback call (runnie's
    decode, either CRF impl) runs as it is and its inputs are kept in the
    list the block receives."""
    from flappie_tpu_torch.ops import crf

    own, calls = crf.viterbi_traceback, []

    def keep(backptr, last_state, nblocks):
        calls.append((backptr, last_state, nblocks))
        return own(backptr, last_state, nblocks)

    crf.viterbi_traceback = keep
    try:
        yield calls
    finally:
        crf.viterbi_traceback = own


def traceback_glue(torch, calls: list, env=None):
    """A run's tracebacks (captured_tracebacks' calls) replayed GLUE_REPS
    times under torch.profiler with the run's knobs: device ms a run of
    the traceback kernel and of the rest viterbi_traceback launches (the
    glue: layout copies, casts, flips, the concatenation), and the glue's
    kernels by ms; None when no device events were recorded."""
    from torch.profiler import ProfilerActivity, profile

    from flappie_tpu_torch.ops import crf

    with knobs(env), torch.inference_mode():
        for c in calls:
            crf.viterbi_traceback(*c)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(GLUE_REPS):
                for c in calls:
                    crf.viterbi_traceback(*c)
            torch.cuda.synchronize()
    got = device_time(prof)
    if got is None:
        return None
    kernel = {n: us for n, us in got[2].items() if "Trace" in n or "traceback_kernel" in n}
    glue = {n: us / 1e3 / GLUE_REPS for n, us in got[2].items() if n not in kernel}
    return sum(kernel.values()) / 1e3 / GLUE_REPS, sum(glue.values()), glue


def profiled_runnie(torch, reads_dir: str, card: str, env=None, what: str = "") -> dict:
    """runnie's fb run once more under torch.profiler (``env``: knobs for
    this run): the device busy share of the wall and kernel time by name,
    then the run's tracebacks replayed (traceback_glue): the kernel's time
    beside its glue's.  Returns the device ms of each KERNEL_GROUPS group
    in the run (0 for the impl the run did not take) and "glue": the
    glue's ms a run (None if not measured)."""
    from torch.profiler import ProfilerActivity, profile

    from flappie_tpu_torch.cli.runnie import main as runnie_main

    out = os.path.join(os.path.dirname(reads_dir), "gpu_fb_profiled.run")
    with captured_tracebacks() as calls, profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = run_cli(torch, [reads_dir, "-o", out], runnie_main, env)
    knob = "".join(f" {k}={v}" for k, v in (env or {}).items())
    log_profile(f"rle_r941_native (runnie fb run{knob}{what}, profiler on)", prof, wall, card)
    got = device_time(prof)
    groups = group_ms({} if got is None else got[2])
    glue = traceback_glue(torch, calls, env) if calls else None
    if not calls:
        log("  traceback glue: none (the default impl's decode hands K5's backpointers to K6)")
    elif glue is None:
        log("  traceback glue: no device events recorded; not measured")
    else:
        log(f"  the run's {len(calls)} tracebacks replayed {GLUE_REPS}x under the profiler: "
            f"kernel {glue[0]:.4f} ms a run, glue {glue[1]:.4f} ms a run ("
            + ", ".join(f"{ms:.4f} {n[:60]}" for n, ms in
                        sorted(glue[2].items(), key=lambda kv: -kv[1])[:5]) + ")")
    return {**groups, "glue": None if glue is None else glue[1]}


# -- phase 3, the sloika-era graphs and the converters -----------------------

# the sloika/guppy model's conv (winlen 19, 1 -> 256 filters, stride 2) and
# the recurrent width of every model of flappie_tpu_torch/models/config.py
SLOIKA_H, SLOIKA_WINLEN, SLOIKA_STRIDE = 256, 19, 2
SLOIKA_FLAVOURS = ("flipflop_gru", "flipflop_grumod", "runlength")
# the flip-flop flavours' reads: 32 chunked (2560-block chunks of 5120
# samples, one 256-chunk batch), then 4 short ones (the bucket programs)
# held to the CPU path
SLOIKA_READS = ((32, 12_000, 30_000), (4, 2_000, 4_000))
# the registry models whose synthetic weights round-trip through
# npz2header and header2npz
HEADER_MODELS = (("r941_native", "r941native"), ("r941_5mC", "r941native5mC"))


def write_sloika_pickle(np, path: str, flavour: str, seed: int) -> None:
    """A sloika network pickle of ``flavour`` at full width (the layout
    flappie_tpu_torch/weights/sloika.py reads: sublayers[0] the conv,
    [1..5] the GRUs, backward ones wrapped in Reverse (and Residual)
    containers, [6] the output layer; matrices [out, in]; each value
    buried in a theano-shared-like container), seeded.  Its classes are a
    throwaway module's, removed once pickled, so that loading meets what
    real sloika pickles meet: classes that cannot be imported (the
    converter's stubs)."""
    import pickle
    import types

    mod = types.ModuleType("chip_smoke_sloika_layers")

    class Shared:
        def __init__(self, v):
            self.container = {"storage": [np.asarray(v, np.float32)]}

    class Layer:
        pass

    for cls in (Shared, Layer):
        cls.__module__, cls.__qualname__ = mod.__name__, cls.__name__
        setattr(mod, cls.__name__, cls)

    def layer(**attrs):
        obj = Layer()
        obj.__dict__.update(attrs)
        return obj

    def wrap(inner, levels):
        for _ in range(levels):
            inner = layer(sublayers=[inner])
        return inner

    rng = np.random.default_rng(seed)
    H = SLOIKA_H

    def w(*shape):
        return Shared(rng.normal(0.0, shape[-1] ** -0.5, shape))

    layers = [layer(W=w(H, 1, SLOIKA_WINLEN), b=Shared(rng.normal(0.0, 0.1, H)),
                    stride=SLOIKA_STRIDE)]
    for i in range(5):
        if flavour == "flipflop_gru":  # Reverse(Residual(gru)) or Residual(gru)
            gru = layer(iW=w(3 * H, H), sW=w(2 * H, H), sW2=w(H, H),
                        b=Shared(rng.normal(0.0, 0.1, 3 * H)))
            layers.append(wrap(gru, 2 if i % 2 == 0 else 1))
        else:  # Reverse(gru) or gru
            gru = layer(iW=w(3 * H, H), sW=w(3 * H, H), b=Shared(rng.normal(0.0, 0.1, 3 * H)))
            layers.append(wrap(gru, 1 if i % 2 == 0 else 0))
    out = 16 if flavour == "runlength" else 40
    layers.append(layer(W=w(out, H), b=Shared(rng.normal(0.0, 0.1, out))))
    sys.modules[mod.__name__] = mod
    try:
        with open(path, "wb") as fh:
            pickle.dump(layer(version=(2, 0), sublayers=layers), fh, protocol=2)
    finally:
        del sys.modules[mod.__name__]


def convert_cli(args: list) -> str:
    """flappie-torch-convert in this process: its printed line."""
    from flappie_tpu_torch.cli.convert import main

    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = main(args)
    if rc != 0:
        raise AssertionError(f"flappie-torch-convert exited {rc} for {args}")
    return out.getvalue().strip()


def sloika_checkpoint(np, flavour: str):
    """(cfg, params) of a seeded sloika pickle of ``flavour``, converted
    by flappie-torch-convert sloika2npz and read by load_sloika_npz, its
    graph checked against the flavour's."""
    from flappie_tpu_torch.weights.sloika import load_sloika_npz

    d = os.path.join(WORK, "sloika")
    os.makedirs(d, exist_ok=True)
    pkl, npz = os.path.join(d, f"{flavour}.pkl"), os.path.join(d, f"{flavour}.npz")
    write_sloika_pickle(np, pkl, flavour, seed=SLOIKA_FLAVOURS.index(flavour) + 13)
    line = convert_cli(["sloika2npz", pkl, npz, "--flavour", flavour, "--name", flavour])
    cfg, params = load_sloika_npz(npz)
    kind = "gru" if flavour == "flipflop_gru" else "grumod"
    (conv,) = cfg.convs
    if ((conv.winlen, conv.in_ch, conv.out_ch, conv.stride) != (SLOIKA_WINLEN, 1, SLOIKA_H,
                                                                 SLOIKA_STRIDE)
            or [(r.kind, r.size, r.backward, r.residual) for r in cfg.rnns]
            != [(kind, SLOIKA_H, i % 2 == 0, flavour == "flipflop_gru") for i in range(5)]
            or cfg.head != ("runlength" if flavour == "runlength" else "flipflop")
            or cfg.nbase != 4):
        raise AssertionError(f"sloika {flavour}: converted to {cfg}")
    log(f"sloika {flavour}: pickle -> flappie-torch-convert sloika2npz ({line}) -> "
        f"load_sloika_npz")
    return cfg, params


def sloika_flipflop(torch, np, card: str, flavour: str) -> dict:
    """A flip-flop sloika flavour through Basecaller(model=cfg,
    params=params) on the card: 32 chunked reads with exact launch
    counts, then 4 short reads held to the port's CPU path by the band
    (identity >= 99.5%, |normalised score delta| <= 1e-4).  Returns the
    chunked run's launch counts."""
    from flappie_tpu_torch.basecall import Basecaller, preprocess_batch
    from flappie_tpu_torch.models.network import fused
    from flappie_tpu_torch.signal.fast5 import read_raw

    cfg, params = sloika_checkpoint(np, flavour)
    reads_dir = os.path.join(WORK, "sloika", flavour)
    names = write_reads(np, np.random.default_rng(20261017), reads_dir, *SLOIKA_READS)
    nlong = SLOIKA_READS[0][0]

    def raws(part):
        return [read_raw(os.path.join(reads_dir, n)) for n, _ in part]

    P = count_programs(preprocess_batch(raws(names[:nlong])), cfg)
    want = {k: n * P for k, n in FB_CRF.items()}
    if fused(cfg):  # GRU-mod: K7 a layer; the sloika GRU's time loop has no kernel
        want["grumod_layer"] = len(cfg.rnns) * P
    caller = Basecaller(model=cfg, params=params)
    nsample = sum(n for _, n in names[:nlong])
    with knobs():
        reads = raws(names[:nlong])
        zero_counts()
        t0 = time.perf_counter()
        got = caller.basecall_raw_tables(reads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = check_counts(f"sloika {flavour}", want)
    if any(r is None or not r.basecall or set(r.basecall) - set("ACGT") for r in got):
        raise AssertionError(f"sloika {flavour}: a read without a call")
    log(f"sloika {flavour} on the card: {nlong} reads, {nsample} samples, {P} chunk "
        f"program(s), wall {wall:.3f} s = {nsample / wall / 1e6:.3f} Msamples/s, "
        f"{sum(len(r.basecall) for r in got)} bases, launches {json.dumps(counts)} [{card}]")

    short = names[nlong:]
    with knobs():
        gpu = caller.basecall_raw_tables(raws(short))
        t0 = time.perf_counter()
        cpu = Basecaller(model=cfg, params=params, device="cpu").basecall_raw_tables(raws(short))
        cpu_wall = time.perf_counter() - t0
    worst_id, worst_ds = 1.0, 0.0
    for (n, _), g, c in zip(short, gpu, cpu):
        ident = identity(g.basecall, c.basecall)
        ds = abs(g.score / g.nblock - c.score / c.nblock)
        worst_id, worst_ds = min(worst_id, ident), max(worst_ds, ds)
        if not (ident >= 0.995 and ds <= 1e-4 and g.nblock == c.nblock):
            raise AssertionError(f"sloika {flavour} {n}: outside the band against the CPU "
                                 f"(identity {ident}, score delta {ds})")
    log(f"sloika {flavour}: {len(short)} short reads held to the CPU path (cpu wall "
        f"{cpu_wall:.1f} s): min identity {worst_id:.6f}, max |score delta| {worst_ds:.2e}, "
        f"{sum(g.basecall == c.basecall and g.quality == c.quality for g, c in zip(gpu, cpu))} "
        "calls byte-equal")
    return counts


# the V1 decode's kernel launches under each CRF impl: the Viterbi (K5 and
# K6, or K11's Viterbi and traceback) and the posterior's two scans (K3 and
# K4, or K11's forward scan twice)
V1_RUNS = {
    "runlength_v1": ({}, {"crf_viterbi": 1, "crf_traceback": 1, "crf_sum_scan": 2}),
    "runlength_v1_pallas": ({"FLAPPIE_TPU_CRF_IMPL": "pallas"},
                            {"crf_bt_viterbi": 1, "crf_bt_traceback": 1, "crf_bt_fwd": 2}),
}
# reads of the V1 batch held to the CPU path
V1_CPU_READS = 2


def sloika_runlength(torch, np, card: str, peak: dict, libs: dict) -> tuple:
    """The V1 run-length flavour on the card: transitions over one full
    batch (B=256 reads of 5120 samples, 2560 blocks; the last 8 ragged,
    one empty), decoded by rle_v1_viterbi and rle_v1_posterior under each
    CRF impl (V1_RUNS) with exact launch counts, path and score equal
    across the impls; 2 reads' transitions and Viterbi held to the CPU
    path; then each S=4 kernel held to its plain version on this batch's
    own V1 chain, timed, with its bound.  Returns (rows, launches by
    run)."""
    from flappie_tpu_torch.decode.runlength import rle_v1_index, rle_v1_posterior, rle_v1_viterbi
    from flappie_tpu_torch.models.network import transitions
    from flappie_tpu_torch.models.params import params_to_torch
    from flappie_tpu_torch.ops.crf import dense_from_params
    from flappie_tpu_torch.ops.crf_bm import _dense_tm

    cfg, params = sloika_checkpoint(np, "runlength")
    tp = params_to_torch(params, "cuda")
    B, W = 256, 2560 * cfg.total_stride
    gen = torch.Generator(device="cuda").manual_seed(4321)
    sig = torch.randn(B, W, generator=gen, device="cuda")
    lengths = torch.full((B,), W, dtype=torch.int32, device="cuda")
    lengths[-8:] = torch.randint(0, W, (8,), generator=gen, device="cuda", dtype=torch.int32)
    lengths[-1] = 0
    with knobs(), torch.inference_mode():
        zero_counts()
        t0 = time.perf_counter()
        trans, nblocks = transitions(tp, cfg, sig, lengths)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_counts("runlength transitions", {"grumod_layer": len(cfg.rnns)})
    T = trans.shape[1]
    if trans.shape != (B, T, 16) or T != 2560 or not bool(torch.isfinite(trans).all()):
        raise AssertionError(f"runlength transitions: shape {tuple(trans.shape)} or not finite")
    log(f"sloika runlength transitions on the card: B={B} x {W} samples, {T} blocks, "
        f"wall {wall:.3f} s (5 K7, the V1 head's partition a time loop) [{card}]")

    launches, decoded = {}, {}
    for run, (env, want) in V1_RUNS.items():
        with knobs(env), torch.inference_mode():
            zero_counts()
            t0 = time.perf_counter()
            score, path = rle_v1_viterbi(trans, nblocks, cfg.nbase)
            post = rle_v1_posterior(trans, nblocks, cfg.nbase)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[run] = check_counts(f"{run} decode", want)
        decoded[run] = score, path, post
        log(f"{run}: rle_v1_viterbi + rle_v1_posterior over {B} x {T} blocks, wall {wall:.3f} s, "
            f"launches {json.dumps(launches[run])} [{card}]")
    (s0, p0, q0), (s1, p1, q1) = decoded.values()
    t = torch.arange(T, device="cuda")[None, :]
    moves = (p0 >= 0) & (t < nblocks[:, None])
    if not (torch.equal(s0, s1) and torch.equal(p0, p1)):
        raise AssertionError("runlength V1: the path or score differs between the CRF impls")
    if bool(((p0 < -1) | (p0 > 3) | ((t >= nblocks[:, None]) & (p0 != -1))).any()):
        raise AssertionError("runlength V1: a path entry outside the V1 convention")
    if not (bool(torch.isfinite(q0).all())
            and bool(((q1 - q0).abs() <= 1e-5 * q0.abs() + 1e-4).all())):
        raise AssertionError("runlength V1: the posteriors differ between the CRF impls")
    log(f"runlength V1: path and score equal under both impls, posteriors within rtol 1e-5 "
        f"(max |delta| {(q1 - q0).abs().max().item():.2e}); {int(moves.sum())} moves in "
        f"{int(nblocks.sum())} blocks")

    n = V1_CPU_READS
    cpu = params_to_torch(params, "cpu")
    with knobs(), torch.inference_mode():
        t0 = time.perf_counter()
        tc, nc = transitions(cpu, cfg, sig[:n].cpu(), lengths[:n].cpu())
        sc, pc = rle_v1_viterbi(trans[:n].cpu(), nblocks[:n].cpu(), cfg.nbase)
        cpu_wall = time.perf_counter() - t0
    dt = (tc - trans[:n].cpu()).abs().max().item()
    if not (torch.equal(nc, nblocks[:n].cpu()) and dt <= 1e-4 and torch.equal(pc, p0[:n].cpu())
            and torch.equal(sc, s0[:n].cpu())):
        raise AssertionError(f"runlength V1: {n} reads against the CPU path (transitions "
                             f"max |delta| {dt:.2e}, the Viterbi over the card's transitions)")
    log(f"runlength V1: {n} reads' transitions within {dt:.2e} of the CPU path's, the "
        f"Viterbi over the card's transitions bit-equal on the CPU (cpu wall {cpu_wall:.1f} s)")

    idx = rle_v1_index(cfg.nbase)
    tvalid = torch.arange(T, device="cuda")[:, None] < nblocks[None, :]
    with torch.inference_mode():
        dense_bm = _dense_tm(trans.permute(1, 2, 0).contiguous(), idx)  # [T, 4, 4, B]
        dense_bt = dense_from_params(trans.transpose(0, 1), idx)  # [T, B, 4, 4]
    rows = check_chain_scans(torch, peak, libs, dense_bm, tvalid, idx, "runlength_v1", "_s4")
    rows += check_bt_chain(torch, peak, libs, dense_bt, tvalid, idx, "K11 V1 S=4",
                           "runlength_v1_pallas", "_s4", builds=True, profile=False)
    for r in rows:
        log(f"S=4 {r['kid']} {r['name']} at T={T}, B={B}: {r['ms']:.4f} ms = "
            f"{1e6 * r['ms'] / T:.1f} ns a step, plain {r['plain_ms']:.1f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max |kernel - plain| "
            f"{r['max_abs_err']:.2e}, launches a V1 decode {launches[r['run']][r['counter']]} "
            f"[{card}]")
    return rows, launches


def header_paths(model: str) -> tuple:
    d = os.path.join(WORK, "convert")
    return tuple(os.path.join(d, f"{model}{x}") for x in (".npz", ".h", "_2.npz", "_2.h"))


def start_header_roundtrips() -> list:
    """flappie-torch-convert's header subcommands at full width, as a user
    runs them (one process a command), for each of HEADER_MODELS: synth ->
    npz2header -> header2npz -> npz2header, one chain a model in the
    background (host work of tens of seconds, while the card works):
    [(model, process)]."""
    os.makedirs(os.path.join(WORK, "convert"), exist_ok=True)
    env = {**os.environ, "PYTHONPATH": HERE + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = []
    for model, mid in HEADER_MODELS:
        npz, h1, npz2, h2 = header_paths(model)
        cli = [sys.executable, "-m", "flappie_tpu_torch.cli.convert"]
        chain = [["synth", npz, "--model", model, "--seed", "5"],
                 ["npz2header", npz, h1, "--model", model, "--id", mid],
                 ["header2npz", h1, npz2],
                 ["npz2header", npz2, h2, "--model", model, "--id", mid]]
        script = " && ".join(" ".join(shlex.quote(a) for a in cli + c) for c in chain)
        procs.append((model, subprocess.Popen(["sh", "-c", script], cwd=HERE, env=env,
                                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                              text=True)))
    return procs


def finish_header_roundtrips(np, procs: list, t0: float) -> None:
    """Wait for start_header_roundtrips' chains: the two headers of each
    model byte-equal, header2npz's arrays the synthetic ones; then
    torch2npz, in this process, on a synthetic taiyaki state dict of
    r941_5mC (cudnn GRU gates reordered; the MAD scale on the first
    conv)."""
    import torch

    from flappie_tpu_torch.models.config import get_model_config
    from flappie_tpu_torch.models.params import flatten, load_npz

    d = os.path.join(WORK, "convert")
    for model, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"flappie-torch-convert chain for {model} exited "
                                 f"{proc.returncode}:\n{out}{err}")
        npz, h1, npz2, h2 = header_paths(model)
        with open(h1, "rb") as a, open(h2, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{model}: npz2header after header2npz is not byte-equal")
        p1, p2 = flatten(load_npz(npz)), flatten(load_npz(npz2))
        if sorted(p1) != sorted(p2) or any(not np.array_equal(p1[k], p2[k]) for k in p1):
            raise AssertionError(f"{model}: header2npz arrays differ from the synthetic ones")
    cfg = get_model_config("r941_5mC")
    (conv,) = cfg.convs
    H = cfg.rnns[0].size
    rng = np.random.default_rng(6)
    state = {"sublayers.1.conv.weight": rng.normal(size=(conv.out_ch, 1, conv.winlen)),
             "sublayers.1.conv.bias": rng.normal(size=conv.out_ch)}
    for i, r in enumerate(cfg.rnns):
        pre = f"sublayers.{i + 2}.cudnn_gru."
        state.update({pre + "weight_ih_l0": rng.normal(size=(3 * H, conv.out_ch if i == 0 else H)),
                      pre + "weight_hh_l0": rng.normal(size=(3 * H, H)),
                      pre + "bias_ih_l0": rng.normal(size=3 * H)})
    state["sublayers.7.linear.weight"] = rng.normal(size=(cfg.out_dim, H))
    state["sublayers.7.linear.bias"] = rng.normal(size=cfg.out_dim)
    ckpt, out = os.path.join(d, "taiyaki.pt"), os.path.join(d, "taiyaki.npz")
    torch.save({"model_state_dict": {k: torch.tensor(v, dtype=torch.float32)
                                     for k, v in state.items()}}, ckpt)
    convert_cli(["torch2npz", ckpt, out, "--model", "r941_5mC", "--scale"])
    got = load_npz(out)
    iW = state["sublayers.2.cudnn_gru.weight_ih_l0"].astype(np.float32)
    want_iW = np.concatenate([iW[H : 2 * H], iW[:H], iW[2 * H :]]).T
    want_conv = (state["sublayers.1.conv.weight"].astype(np.float32).transpose(2, 1, 0)
                 * np.float32(1.4826))
    if not (np.array_equal(got["rnn0"]["iW"], want_iW)
            and np.allclose(got["conv0"]["W"], want_conv, rtol=1e-6, atol=0)):
        raise AssertionError("torch2npz: the GRU gates or the conv's MAD scale are wrong")
    log(f"flappie-torch-convert: synth -> npz2header -> header2npz -> npz2header byte-equal "
        f"for {', '.join(m for m, _ in HEADER_MODELS)} at full width ({time.perf_counter() - t0:.1f} "
        "s after the chains started, beside the sloika runs), torch2npz of a taiyaki state dict "
        "(r941_5mC, --scale) checked")


def sloika_phase(torch, np, card: str, peak: dict, libs: dict) -> tuple:
    """The three sloika flavours at full width and the converters: (rows
    of the S=4 kernels, launches by run)."""
    launches = {}
    t0 = time.perf_counter()
    procs = start_header_roundtrips()
    try:
        for flavour in ("flipflop_gru", "flipflop_grumod"):
            launches[f"sloika_{flavour}"] = sloika_flipflop(torch, np, card, flavour)
        rows, v1 = sloika_runlength(torch, np, card, peak, libs)
        launches.update(v1)
        finish_header_roundtrips(np, procs, t0)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return rows, launches


# -- phase 3, --fast: the bf16 stream --------------------------------------------

# rounds of exact and --fast runs, alternated, on each main path (3 until
# the knobs phase was added; 2 keep the script inside its time)
FAST_ROUNDS = 2
# the accuracy band's corpus: 64 seeded reads of 16k-28k samples, above the
# chunk size and inside one runnie bucket
ACCURACY_READS = (64, 16_000, 28_000)
ACCURACY_MODELS = ("r941_native", "r941_5mC", "rle_r941_native")


def fast_counts(counts: dict, layer: str) -> dict:
    """An exact run's launch counts with the f32 layer's launches moved
    to its bf16 twin (and the bf16 affine it launches)."""
    out = dict(counts)
    n = out.pop(layer)
    out[f"{layer}_bf16"] = n
    out["affine_bf16"] = n
    return out


def fast_vs_exact(torch, card: str, what: str, args: list, want: dict, layer: str,
                  outdir: str, main=None, suffix: str = ".fastq") -> tuple:
    """FAST_ROUNDS rounds of the exact run and the --fast run of ``args``,
    alternated (exact first in even rounds), each with exact launch counts
    (``want``: the exact run's; --fast moves ``layer`` to its bf16 twin);
    each mode's outputs equal across rounds, FLAPPIE_TPU_RNN_STREAM never
    set.  Logs the walls; returns (exact text, fast text, the --fast
    run's counts)."""
    walls, texts, counts = {"exact": [], "fast": []}, {"exact": set(), "fast": set()}, None
    for i in range(FAST_ROUNDS):
        for mode in ("exact", "fast") if i % 2 == 0 else ("fast", "exact"):
            out = os.path.join(outdir, f"{mode}_{i}{suffix}")
            extra = ["--fast"] if mode == "fast" else []
            wall, got = counted_run(torch, f"{what} {mode}", args + ["-o", out] + extra,
                                    want if mode == "exact" else fast_counts(want, layer), main)
            if "FLAPPIE_TPU_RNN_STREAM" in os.environ:
                raise AssertionError(f"{what} {mode}: the CLI set FLAPPIE_TPU_RNN_STREAM")
            walls[mode].append(wall)
            with open(out) as fh:
                texts[mode].add(fh.read())
            counts = got if mode == "fast" else counts
    if len(texts["exact"]) != 1 or len(texts["fast"]) != 1:
        raise AssertionError(f"{what}: a mode's output differs between rounds")
    log(f"--fast {what}: walls exact {[round(w, 3) for w in walls['exact']]} s, --fast "
        f"{[round(w, 3) for w in walls['fast']]} s (alternated; medians "
        f"{statistics.median(walls['exact']):.3f} and {statistics.median(walls['fast']):.3f}, "
        f"--fast/exact {statistics.median(walls['fast']) / statistics.median(walls['exact']):.3f});"
        f" --fast launches {json.dumps(counts)} [{card}]")
    return texts["exact"].pop(), texts["fast"].pop(), counts


def fast_main_paths(torch, np, card: str) -> dict:
    """--fast on the main paths, each beside its exact run (fast_vs_exact):
    r941_native fb on its 80 reads (5 K1-bf16 and no K1 a program), r941_5mC
    (K7-bf16) and runnie fb on their reads; the exact runs byte-equal to
    the main path's; the --fast records' identity to the exact ones
    logged.  Returns the launch counts of the --fast runs by run name."""
    from flappie_tpu_torch.basecall import preprocess_batch
    from flappie_tpu_torch.cli.runnie import main as runnie_main
    from flappie_tpu_torch.models.config import get_model_config
    from flappie_tpu_torch.signal.fast5 import read_raw

    launches = {}
    for model in RUNS:
        cfg = get_model_config(model)
        layer = {"lstm": "lstm_layer", "grumod": "grumod_layer"}[cfg.rnns[0].kind]
        wdir = os.path.join(WORK, model)
        reads_dir = os.path.join(wdir, "reads")
        outdir = os.path.join(wdir, "fast")
        os.makedirs(outdir)
        pre = preprocess_batch([read_raw(os.path.join(reads_dir, n))
                                for n in sorted(os.listdir(reads_dir))])
        P = count_programs(pre, cfg)
        want = {layer: len(cfg.rnns) * P, **{k: n * P for k, n in FB_CRF.items()}}
        exact, fast, launches[f"{model}_fast"] = fast_vs_exact(
            torch, card, f"{model} fb ({len(pre)} reads, {P} programs)",
            [reads_dir, "--model", model], want, layer, outdir)
        with open(os.path.join(wdir, "gpu_fb.fastq")) as fh:
            if fh.read() != exact:
                raise AssertionError(f"{model}: the exact run differs from the main path's")
        alphabet = "ACGTZ"[: cfg.nbase]
        log_band(f"--fast {model} main path", band(fastq_calls(exact, alphabet),
                                                   fastq_calls(fast, alphabet)))

    cfg = get_model_config("rle_r941_native")
    wdir = os.path.join(WORK, "rle_r941_native")
    reads_dir = os.path.join(wdir, "reads")
    outdir = os.path.join(wdir, "fast")
    os.makedirs(outdir)
    names = [(n, 0) for n in sorted(os.listdir(reads_dir))]
    P, _ = runnie_buckets(reads_dir, names)
    want = {"lstm_layer": len(cfg.rnns) * P, "crf_sum_scan": 3 * P, "crf_viterbi": P,
            "crf_traceback": P}
    exact, fast, launches["rle_r941_native_fast"] = fast_vs_exact(
        torch, card, f"runnie fb ({len(names)} reads, {P} programs)", [reads_dir], want,
        "lstm_layer", outdir, runnie_main, ".run")
    with open(os.path.join(wdir, "gpu_fb_scanb.run")) as fh:
        if fh.read() != exact:
            raise AssertionError("runnie: the exact run differs from the main path's")
    log_band("--fast runnie main path", band(run_calls(exact), run_calls(fast)))
    return launches


def serve_fast_request(torch, card: str) -> dict:
    """One flappie-serve request (serve stdin's first directory) on a warm
    --fast server beside the same request on a warm exact server,
    alternated FAST_ROUNDS times, each with exact launch counts; the --fast
    records byte-equal to the flappie CLI's --fast records on the same
    files.  Returns the --fast request's counts."""
    from flappie_tpu_torch.cli import serve
    from flappie_tpu_torch.models.config import get_model_config

    cfg = get_model_config("r941_native")
    request = os.path.join(WORK, "serve", "run1")
    names = [(n, 0) for n in sorted(os.listdir(request))]
    P = expected_programs(request, names, cfg)
    want = serve_counts(P)
    servers = {"exact": serve.Server(serve_args([])), "fast": serve.Server(serve_args(["--fast"]))}
    walls, texts, counts = {"exact": [], "fast": []}, {"exact": set(), "fast": set()}, None
    for i in range(FAST_ROUNDS):
        for mode in ("exact", "fast") if i % 2 == 0 else ("fast", "exact"):
            out = io.StringIO()
            zero_counts()
            t0 = time.perf_counter()
            with captured_stderr():
                seen, called = servers[mode].handle(request, out)
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
            got = check_counts(f"serve request {mode}",
                               want if mode == "exact" else fast_counts(want, "lstm_layer"))
            counts = got if mode == "fast" else counts
            if (seen, called) != (len(names), len(names)):
                raise AssertionError(f"serve {mode}: {called} of {seen} reads called")
            texts[mode].add(out.getvalue())
    if len(texts["exact"]) != 1 or len(texts["fast"]) != 1:
        raise AssertionError("serve: a mode's records differ between requests")
    cli_out = os.path.join(WORK, "serve", "cli_fast.fastq")
    run_cli(torch, [request, "-o", cli_out, "--fast"])
    with open(cli_out) as fh:
        if fh.read() != next(iter(texts["fast"])):
            raise AssertionError("serve --fast: the request's records differ from the CLI's "
                                 "--fast records")
    log(f"--fast flappie-serve, one request of {len(names)} reads ({P} programs) on warm "
        f"servers: exact {[round(w, 3) for w in walls['exact']]} s, --fast "
        f"{[round(w, 3) for w in walls['fast']]} s (alternated); the --fast records "
        f"byte-equal to the CLI's --fast records; launches {json.dumps(counts)} [{card}]")
    return counts


def fastq_calls(text: str, alphabet: str) -> dict:
    """FASTQ text -> {read file: (sequence, quality)}."""
    return {n: (r[0], r[2].split("\n")[3]) for n, r in parse_fastq(text, alphabet).items()}


def run_calls(text: str) -> dict:
    """.run text -> {uuid: (the run-length calls expanded, None)}."""
    from flappie_tpu_torch.io.run_format import read_run_records, runlength_basecall

    return {u: (runlength_basecall(rows) or "", None)
            for u, rows in read_run_records(io.StringIO(text))}


def identity_of(pair) -> float:
    """align_identity's identity of (fast call, exact call); a worker's job."""
    from flappie_tpu_torch.accuracy import align_identity

    fast, exact = pair
    return 1.0 if fast == exact else align_identity(fast, exact).identity


# band()'s 4 identity worker processes: started by the first band of
# fast_phase and shut down at its end (each start imports the package anew,
# seconds that 14 bands paid apart)
_band_workers = None


def band(exact: dict, fast: dict) -> dict:
    """The accuracy band of ``fast`` against ``exact`` ({read: (sequence,
    quality or None)}): per-read identity (flappie_tpu_torch.accuracy,
    in 4 worker processes), reads missing from fast, and the largest phred
    shift over the reads whose calls have equal lengths."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    global _band_workers
    if _band_workers is None:
        _band_workers = ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn"))
    keys = sorted(k for k in exact if k in fast)
    pairs = [(fast[k][0], exact[k][0]) for k in keys]
    ids = 100 * np.asarray(list(_band_workers.map(identity_of, pairs, chunksize=4)))
    shifts = [max(abs(ord(a) - ord(b)) for a, b in zip(fast[k][1], exact[k][1]))
              for k in keys if exact[k][1] and len(fast[k][1]) == len(exact[k][1])]
    return {"reads": len(keys), "missing_in_fast": len(exact) - len(keys),
            "p5": float(np.percentile(ids, 5)), "p50": float(np.percentile(ids, 50)),
            "min": float(ids.min()), "identical": int((ids == 100.0).sum()),
            "aligned": len(shifts), "max_phred_shift": max(shifts) if shifts else None}


def log_band(what: str, res: dict) -> None:
    log(f"{what}: accuracy band of --fast against the exact stream: {json.dumps(res)}")


def accuracy_band(torch, np, card: str) -> dict:
    """The accuracy band: ACCURACY_READS' corpus basecalled exact and
    --fast through the port's CLIs for each of ACCURACY_MODELS (runnie's
    run-length calls expanded); fails if a read is missing from the --fast
    output or the median identity is under 90% (a broken kernel, not the
    band: the weights are synthetic).  Returns {model: band}."""
    from flappie_tpu_torch.cli.runnie import main as runnie_main
    from flappie_tpu_torch.models.config import get_model_config

    wdir = os.path.join(WORK, "accuracy")
    reads_dir = os.path.join(wdir, "reads")
    names = write_reads(np, np.random.default_rng(20261020), reads_dir, ACCURACY_READS,
                        (0, 0, 1))
    nsample = sum(n for _, n in names)
    out = {}
    for model in ACCURACY_MODELS:
        calls, walls = {}, {}
        for mode in ("exact", "fast"):
            runnie = model.startswith("rle")
            path = os.path.join(wdir, f"{model}_{mode}" + (".run" if runnie else ".fastq"))
            args = [reads_dir, "-o", path] + ([] if runnie else ["--model", model])
            walls[mode] = run_cli(torch, args + (["--fast"] if mode == "fast" else []),
                                  runnie_main if runnie else None)
            with open(path) as fh:
                text = fh.read()
            calls[mode] = (run_calls(text) if runnie else
                           fastq_calls(text, "ACGTZ"[: get_model_config(model).nbase]))
        res = band(calls["exact"], calls["fast"])
        out[model] = res
        log(f"accuracy band {model}: {len(names)} reads, {nsample} samples; wall exact "
            f"{walls['exact']:.3f} s, --fast {walls['fast']:.3f} s; identity of --fast to the "
            f"exact stream p5 {res['p5']:.3f}%, p50 {res['p50']:.3f}%, min {res['min']:.3f}%, "
            f"{res['identical']} of {res['reads']} reads identical, {res['missing_in_fast']} "
            f"missing from --fast, largest phred shift {res['max_phred_shift']} over "
            f"{res['aligned']} reads of equal length [{card}]")
        if res["missing_in_fast"] or res["reads"] != len(names) or res["p50"] < 90.0:
            raise AssertionError(f"accuracy band {model}: {res}")
    return out


@contextlib.contextmanager
def precision_levels(ff: str = None, rnn: str = None):
    """FLAPPIE_TPU_MATMUL_PRECISION / FLAPPIE_TPU_RNN_PRECISION's levels
    (ops/precision.py, read at import) set for the block, restored
    after it."""
    from flappie_tpu_torch.ops import precision

    saved = precision._ff_level, precision._rnn_level
    try:
        if ff:
            precision.set_ff_precision(ff)
        if rnn:
            precision.set_rnn_precision(rnn)
        yield
    finally:
        precision._ff_level, precision._rnn_level = saved


# the default band's runs: (run name, model, --fast, the recurrent layer's
# counter): both knobs at default on the f32 stream (the one-pass step and
# the one-pass affine) and under --fast (the one-pass step, the bf16 affine,
# counted on the bf16-stream counter)
DEFAULT_RUNS = (("r941_native_default", "r941_native", False, "lstm_layer_p1"),
                ("r941_native_fast_default", "r941_native", True, "lstm_layer_bf16_p1"),
                ("r941_5mC_default", "r941_5mC", False, "grumod_layer_p1"),
                ("r941_5mC_fast_default", "r941_5mC", True, "grumod_layer_bf16_p1"))


def default_band(torch, np, card: str) -> dict:
    """Precision ``default`` on the main path: the accuracy band's 64
    reads basecalled (fb) with FLAPPIE_TPU_MATMUL_PRECISION and
    FLAPPIE_TPU_RNN_PRECISION at default, for r941_native and r941_5mC,
    each on the f32 stream and under --fast, each with exact launch
    counts (5 one-pass recurrences a program, each with its affine: the
    one-pass f32-output affine on the f32 stream, the bf16 one under
    --fast; no f32 or bf16 layer), against the exact run of the accuracy
    band: p5, p50, min, the largest phred shift; a missing read or a
    median under 90% fails the run.  Returns (launch counts by run name,
    bands)."""
    from flappie_tpu_torch.models.config import get_model_config

    wdir = os.path.join(WORK, "accuracy")
    reads_dir = os.path.join(wdir, "reads")
    names = [(n, 0) for n in sorted(os.listdir(reads_dir))]
    launches, bands = {}, {}
    for run, model, fast, layer in DEFAULT_RUNS:
        cfg = get_model_config(model)
        P = expected_programs(reads_dir, names, cfg)
        want = {layer: len(cfg.rnns) * P, **{k: n * P for k, n in FB_CRF.items()},
                ("affine_bf16" if fast else "affine_bf16_f32"): len(cfg.rnns) * P,
                "affine_f32": 0}
        path = os.path.join(wdir, f"{run}.fastq")
        with precision_levels("default", "default"):
            wall, launches[run] = counted_run(
                torch, run, [reads_dir, "-o", path, "--model", model] + (["--fast"] if fast else []),
                want)
        alphabet = "ACGTZ"[: cfg.nbase]
        with open(path) as fh:
            got = fastq_calls(fh.read(), alphabet)
        with open(os.path.join(wdir, f"{model}_exact.fastq")) as fh:
            exact = fastq_calls(fh.read(), alphabet)
        res = band(exact, got)
        bands[run] = res
        log(f"default band {run}: {len(names)} reads, {P} programs, wall {wall:.3f} s; identity "
            f"to the exact run p5 {res['p5']:.3f}%, p50 {res['p50']:.3f}%, min {res['min']:.3f}%, "
            f"{res['identical']} of {res['reads']} reads identical, {res['missing_in_fast']} "
            f"missing, largest phred shift {res['max_phred_shift']} over {res['aligned']} reads "
            f"of equal length; launches {json.dumps(launches[run])} [{card}]")
        if res["missing_in_fast"] or res["reads"] != len(names) or res["p50"] < 90.0:
            raise AssertionError(f"default band {run}: {res}")
    return launches, bands


# the high band's runs: (run name, model, --fast, the recurrent layer's
# counter, the affine's counter): rnn ``high`` on the f32 stream (the
# three-pass step after the f32 affine) and under --fast (after the bf16
# affine, counted on the bf16-stream counter)
HIGH_RUNS = (("r941_native_high", "r941_native", False, "lstm_layer_h3", "affine_f32"),
             ("r941_native_fast_high", "r941_native", True, "lstm_layer_bf16_h3", "affine_bf16"),
             ("r941_5mC_high", "r941_5mC", False, "grumod_layer_h3", "affine_f32"),
             ("r941_5mC_fast_high", "r941_5mC", True, "grumod_layer_bf16_h3", "affine_bf16"))
# the least identity of each read of a high run on the f32 stream to the
# exact run, in percent (PERF.md's GPU-vs-CPU band)
HIGH_IDENTITY = 99.5
# under --fast, the least (median, each read's) identity of a high run to
# the --fast run, in percent.  Each layer rounds its output to bf16 there,
# so a correct f32 step that sums in another order already moves the
# calls: high_witness.py's plain f32 twin against the --fast run reads
# p50 99.226 / 99.677%, min 98.512 / 99.304% (r941_native / r941_5mC;
# H100 80GB HBM3 at 700 W), under the f32 stream's 99.5% per read.  The
# gate sits between those readings (and the three-pass kernels': p50
# 99.177 / 99.339%, min 98.107 / 98.874%) and the one-pass kernels' (p50
# 96.761 / 98.856%, min 95.025 / 97.386%), which the high band's control
# must fail.
HIGH_FAST_IDENTITY = (99.0, 98.0)


def high_band(torch, np, card: str) -> tuple:
    """Rnn precision ``high`` on the main path: the accuracy band's 64
    reads basecalled (fb) with FLAPPIE_TPU_RNN_PRECISION=high, for
    r941_native and r941_5mC, each on the f32 stream and under --fast,
    each with exact launch counts (5 three-pass recurrences a program,
    each with its affine: the f32 one, or the bf16 one under --fast; no
    f32-step or one-pass layer), against the accuracy band's run of the
    same stream (the exact run, or its --fast run): no read missing; on
    the f32 stream every read's identity >= HIGH_IDENTITY; under --fast,
    whose layers round each output to bf16 (so a state a few f32 ulps away
    flips some outputs by a bf16 ulp, and the next layer carries it), the
    median and each read's identity at least HIGH_FAST_IDENTITY, which the
    control, the default band's --fast run of the same model (the
    one-pass step) against the same --fast run, must fail.  The
    byte-equal records, the largest |score delta| and the identities' p5,
    p50 and min logged.  Returns (launch counts by run name, bands)."""
    from flappie_tpu_torch.models.config import get_model_config

    def fast_gate(res):
        return res["p50"] >= HIGH_FAST_IDENTITY[0] and res["min"] >= HIGH_FAST_IDENTITY[1]

    wdir = os.path.join(WORK, "accuracy")
    reads_dir = os.path.join(wdir, "reads")
    names = [(n, 0) for n in sorted(os.listdir(reads_dir))]
    launches, bands = {}, {}
    for run, model, fast, layer, affine in HIGH_RUNS:
        cfg = get_model_config(model)
        P = expected_programs(reads_dir, names, cfg)
        want = {layer: len(cfg.rnns) * P, affine: len(cfg.rnns) * P,
                **{k: n * P for k, n in FB_CRF.items()}}
        path = os.path.join(wdir, f"{run}.fastq")
        with precision_levels(rnn="high"):
            wall, launches[run] = counted_run(
                torch, run, [reads_dir, "-o", path, "--model", model] + (["--fast"] if fast else []),
                want)
        alphabet = "ACGTZ"[: cfg.nbase]
        with open(path) as fh:
            got = parse_fastq(fh.read(), alphabet)
        with open(os.path.join(wdir, f"{model}_{'fast' if fast else 'exact'}.fastq")) as fh:
            ref = parse_fastq(fh.read(), alphabet)
        res = band({k: (v[0], v[2].split("\n")[3]) for k, v in ref.items()},
                   {k: (v[0], v[2].split("\n")[3]) for k, v in got.items()})
        both = [k for k in ref if k in got]
        res["byte_equal"] = sum(got[k][2] == ref[k][2] for k in both)
        res["max_score_delta"] = max(abs(got[k][1] - ref[k][1]) for k in both)
        bands[run] = res
        log(f"high band {run}: {len(names)} reads, {P} programs, wall {wall:.3f} s; against the "
            f"{'--fast' if fast else 'exact'} run: {res['byte_equal']} of {res['reads']} records "
            f"byte-equal, largest |score delta| {res['max_score_delta']:.3e}, identity p5 "
            f"{res['p5']:.3f}%, p50 {res['p50']:.3f}%, min {res['min']:.3f}%, "
            f"{res['identical']} reads identical, {res['missing_in_fast']} missing, largest "
            f"phred shift {res['max_phred_shift']}; launches {json.dumps(launches[run])} [{card}]")
        bad = []
        if fast:
            with open(os.path.join(wdir, f"{model}_fast_default.fastq")) as fh:
                one = fastq_calls(fh.read(), alphabet)
            ctl = band({k: (v[0], v[2].split("\n")[3]) for k, v in ref.items()}, one)
            bands[f"{run}_control"] = ctl
            log(f"high band {run}'s control, the one-pass --fast run against the --fast run: "
                f"identity p50 {ctl['p50']:.3f}%, min {ctl['min']:.3f}% (the gate: p50 >= "
                f"{HIGH_FAST_IDENTITY[0]}%, each read >= {HIGH_FAST_IDENTITY[1]}%)")
            if not fast_gate(res):
                bad.append(f"under the gate {HIGH_FAST_IDENTITY}")
            if fast_gate(ctl):
                bad.append(f"the one-pass control meets the gate: {ctl}")
        elif not res["min"] >= HIGH_IDENTITY:
            bad.append(f"a read under {HIGH_IDENTITY}%")
        if res["missing_in_fast"] or res["reads"] != len(names) or bad:
            raise AssertionError(f"high band {run}: {res}; " + "; ".join(bad))
    return launches, bands


def fast_phase(torch, np, card: str) -> dict:
    """The --fast main paths, one flappie-serve request, the accuracy
    band, the default band and the high band; returns the --fast,
    default and high runs' launch counts by run name."""
    global _band_workers
    try:
        launches = fast_main_paths(torch, np, card)
        launches["r941_native_fast_serve"] = serve_fast_request(torch, card)
        fast_bands = accuracy_band(torch, np, card)
        log("accuracy band (JSON): " + json.dumps(fast_bands))
        default_launches, bands = default_band(torch, np, card)
        launches.update(default_launches)
        log("default band (JSON): " + json.dumps(bands))
        high_launches, bands = high_band(torch, np, card)
        launches.update(high_launches)
        log("high band (JSON): " + json.dumps(bands))
    finally:
        if _band_workers is not None:
            _band_workers.shutdown()
            _band_workers = None
    return launches


# -- phase 3, multi-device and multi-process runs -------------------------------

# the mesh of the one-card host: two replicas of the weights on cuda:0, each
# with its own dispatch thread and streams -- the sharding path, not a
# speed-up
MESH_DEVICES = ("cuda:0", "cuda:0")
# phase 3's r941_native reads that the mesh, launcher and profile runs take:
# its first 8 long reads (one chunk batch of 128 rows) and 8 short ones whose
# buckets hold at least two of them, so that every batch splits in two
MESH_LONG, MESH_SHORT = 8, 8
# the data-parallel training run: r941_native's training shape, two ranks
DP = dict(nproc=2, batch=32, blocks=512, steps=3, seed=0, lr=2e-4)
# kernels the --jax-profile trace must name (K1's recurrence and affine,
# K3/K4, K5, K6)
PROFILE_KERNELS = ("cluster_rnn_kernel", "affine_kernel", "crf_sum_kernel", "crf_viterbi_kernel",
                   "traceback_kernel")


def mesh_reads() -> tuple:
    """Copies MESH_LONG + MESH_SHORT of phase 3's r941_native reads to
    build/chip_smoke/mesh/reads: (directory, names)."""
    from flappie_tpu_torch.basecall import bucket_length, preprocess_batch
    from flappie_tpu_torch.signal.fast5 import read_raw

    src = os.path.join(WORK, "r941_native", "reads")
    names = sorted(os.listdir(src))
    nlong = RUNS["r941_native"][0][0]
    short = names[nlong:]
    pre = preprocess_batch([read_raw(os.path.join(src, n)) for n in short])
    by_bucket: dict = {}
    for n, rt in zip(short, pre):
        by_bucket.setdefault(bucket_length(rt.end - rt.start), []).append(n)
    picked = []
    for group in by_bucket.values():
        k = min(len(group), MESH_SHORT - len(picked))
        if k >= 2:
            picked += group[:k]
    chosen = sorted(names[:MESH_LONG] + picked)
    dst = os.path.join(WORK, "mesh", "reads")
    os.makedirs(dst)
    for n in chosen:
        shutil.copy(os.path.join(src, n), dst)
    return dst, chosen


def read_raws(reads_dir: str, names: list) -> list:
    """The RawTables of ``names`` in ``reads_dir``, as the flappie CLI reads
    them (basecall_raw_tables copies before it changes one)."""
    from flappie_tpu_torch.signal.fast5 import read_raw

    return [read_raw(os.path.join(reads_dir, n), scale_to_pA=True) for n in names]


def library_fastq(torch, caller, raws: list, names: list) -> tuple:
    """(the FASTQ the flappie CLI writes for ``names`` at its defaults,
    basecalled through ``caller`` from their RawTables ``raws``; the wall,
    the device synchronised)."""
    from flappie_tpu_torch.io.fastx import format_read

    t0 = time.perf_counter()
    results = caller.basecall_raw_tables(raws)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return "".join(format_read("fastq", r.uuid, n, True, "", r)
                   for n, r in zip(names, results) if r is not None), wall


def mesh_phase(torch, card: str, reads_dir: str, names: list) -> dict:
    """DistributedBasecaller over MESH_DEVICES against the plain Basecaller
    on the same reads, fb and --viterbi: the band, two shards a dispatch,
    twice the plain run's launches; then the CLI's --mesh refusal on a
    one-card host.  Returns the mesh runs' launch counts."""
    from flappie_tpu_torch.basecall import Basecaller
    from flappie_tpu_torch.cli.flappie import main as flappie_main
    from flappie_tpu_torch.parallel.mesh import make_mesh
    from flappie_tpu_torch.parallel.pipeline import DistributedBasecaller

    launches = {}
    raws = read_raws(reads_dir, names)
    for mode in ("fb", "viterbi"):
        kw = dict(viterbi_only=mode == "viterbi", compute_trace=False)
        plain = Basecaller(**kw)
        library_fastq(torch, plain, raws, names)  # the programs' first calls
        zero_counts()
        want, plain_wall = library_fastq(torch, plain, raws, names)
        plain_counts = {k: fn.launches for k, fn in launch_counters().items() if fn.launches}
        mesh = DistributedBasecaller(mesh=make_mesh(2, devices=list(MESH_DEVICES)), **kw)
        try:
            library_fastq(torch, mesh, raws, names)
            mesh.wire_log.clear()
            zero_counts()
            got, mesh_wall = library_fastq(torch, mesh, raws, names)
            counts = check_counts(f"mesh {mode} (twice the one-device run's {plain_counts})",
                                  {k: 2 * v for k, v in plain_counts.items()})
            summary = mesh.wire_summary()
            shards = [rec["shard_rows"] for rec in mesh.wire_log]
        finally:
            mesh.close()
        if not summary or any(ent["devices"] != [2] for ent in summary.values()):
            raise AssertionError(f"mesh {mode}: a dispatch did not span two shards: {summary}")
        got_recs, want_recs = parse_fastq(got, "ACGT"), parse_fastq(want, "ACGT")
        if list(got_recs) != list(want_recs):
            raise AssertionError(f"mesh {mode}: the records are not in the one-device order")
        compare_fastq(f"mesh {mode} over {list(MESH_DEVICES)} vs one device", got_recs,
                      want_recs)
        launches[f"r941_native_mesh_{mode}"] = counts
        log(f"mesh {mode}: {len(names)} reads, one device {plain_wall:.3f} s, two replicas on "
            f"one card {mesh_wall:.3f} s (the sharding path, not a speed-up); dispatches "
            f"{json.dumps(summary)}, shard rows {shards}; launches {json.dumps(counts)} [{card}]")
    cards = torch.cuda.device_count()
    if cards < 2:
        with captured_stderr() as err:
            rc = flappie_main([reads_dir, "-o", os.devnull, "--mesh", "2"])
        msg = f"--mesh 2 exceeds the {cards} visible devices"
        if rc != 1 or msg not in err.text():
            raise AssertionError(f"flappie --mesh 2 on {cards} card(s): rc {rc}, stderr "
                                 f"{err.text()[-300:]!r}")
        log(f"mesh: the CLI refuses --mesh 2 on this host with rc 1 and {msg!r}")
    return launches


# the model axis on the one-card host: every rnn*/ff leaf in four column
# shards on cuda:0 (one data replica), then two replicas of two shards
TP_MESHES = ((1, 4), (2, 2))
# the model-axis training run: r941_native's training shape on a (1, 4) mesh
TP_TRAIN = dict(batch=32, blocks=512, steps=3, seed=1, lr=2e-4)
# the library step: basecall_read_chunked's reads (samples) at the JAX
# package's defaults, chunk 16000 and overlap 2000
LIBRARY_READS = (60_000, 120_000)
LIBRARY_CHUNK = (16_000, 2_000)


def check_model_shards(torch, caller) -> int:
    """Every rnn*/ff leaf of every data replica of ``caller`` (a
    DistributedBasecaller) is a Sharded whose shard j lies on the row's
    device j and holds exactly its own columns of the whole leaf (a copy
    of its own); the conv leaves are whole.  Returns the shard count."""
    from flappie_tpu_torch.parallel.mesh import Sharded

    n_model, count = caller.mesh.shape["model"], 0
    for rep, row in zip(caller.replicas, caller.mesh.grid):
        for layer, leaves in rep.items():
            for k, leaf in leaves.items():
                full = caller.params[layer][k]
                if not isinstance(leaf, Sharded):
                    if layer.startswith(("rnn", "ff")):
                        raise AssertionError(f"tp: {layer}/{k} is not sharded")
                    continue
                cols = full.shape[-1] // n_model
                for j, (t, dev) in enumerate(zip(leaf.shards, row)):
                    if (t.device != dev or tuple(t.shape) != tuple(full.shape[:-1]) + (cols,)
                            or t.data_ptr() == full.data_ptr()
                            or not torch.equal(t, full[..., j * cols : (j + 1) * cols])):
                        raise AssertionError(f"tp: shard {j} of {layer}/{k} on {t.device}, "
                                             f"shape {tuple(t.shape)}: not its own columns")
                    count += 1
    return count


def tp_phase(torch, np, card: str, reads_dir: str, names: list) -> dict:
    """The mesh's model axis (module docstring, phase 3's tp); returns
    the runs' launch counts."""
    from flappie_tpu_torch.basecall import Basecaller
    from flappie_tpu_torch.models.config import get_model_config
    from flappie_tpu_torch.models.params import init_synthetic
    from flappie_tpu_torch.parallel.mesh import leaf_tensors, make_mesh
    from flappie_tpu_torch.parallel.pipeline import DistributedBasecaller
    from flappie_tpu_torch.train import trainer

    raws = read_raws(reads_dir, names)

    def fastq(caller) -> tuple:
        return library_fastq(torch, caller, raws, names)

    secs, t0 = {}, time.perf_counter()
    kw = dict(compute_trace=False)
    plain = Basecaller(**kw)
    fastq(plain)  # the programs' first calls
    zero_counts()
    want, plain_wall = fastq(plain)
    plain_counts = {k: fn.launches for k, fn in launch_counters().items() if fn.launches}
    runs = {}
    secs["one device"] = time.perf_counter() - t0
    for n_data, n_model in TP_MESHES:
        t0 = time.perf_counter()
        devices = ["cuda:0"] * (n_data * n_model)
        caller = DistributedBasecaller(mesh=make_mesh(n_data, n_model, devices=devices), **kw)
        try:
            shards = check_model_shards(torch, caller)
            fastq(caller)  # the gathers' first allocations
            caller.wire_log.clear()
            zero_counts()
            got, wall = fastq(caller)
            counts = check_counts(f"tp ({n_data}, {n_model}) ({n_data} x the one-device run's "
                                  f"{plain_counts})",
                                  {k: n_data * v for k, v in plain_counts.items()})
            summary = caller.wire_summary()
        finally:
            caller.close()
        what = f"tp ({n_data}, {n_model}) mesh on {devices[0]} x {len(devices)}"
        if any(ent["devices"] != [n_data * n_model] for ent in summary.values()):
            raise AssertionError(f"{what}: a dispatch did not span the mesh: {summary}")
        got_recs, want_recs = parse_fastq(got, "ACGT"), parse_fastq(want, "ACGT")
        if list(got_recs) != list(want_recs):
            raise AssertionError(f"{what}: the records are not in the one-device order")
        if n_data == 1:
            if got != want:
                raise AssertionError(f"{what}: the FASTQ is not byte-equal to one device's")
            log(f"{what}: the FASTQ of {len(names)} reads byte-equal to one device's")
        else:
            compare_fastq(f"{what} vs one device", got_recs, want_recs)
        runs[f"r941_native_tp_{n_data}x{n_model}"] = counts
        secs[f"({n_data}, {n_model})"] = time.perf_counter() - t0
        log(f"{what}: {shards} shards, each its own columns; one device {plain_wall:.3f} s, the "
            f"mesh {wall:.3f} s (the placement path, not a speed-up); dispatches "
            f"{json.dumps(summary)}; launches {json.dumps(counts)} [{card}]")

    # training on a (1, 4) mesh against one device, the same batch and
    # weights, both under torch's deterministic algorithms: with the default
    # ones two one-device runs already differ (5 of the 23 first gradients
    # in their last bits), and Adam carries any difference on
    t0 = time.perf_counter()
    cfg = get_model_config("r941_native")
    dev = torch.device("cuda")
    B, steps = TP_TRAIN["batch"], TP_TRAIN["steps"]
    batch = [torch.from_numpy(a).to(dev) for a in trainer.synthetic_batch(
        cfg, B, TP_TRAIN["blocks"] * cfg.total_stride, TP_TRAIN["seed"])]
    weights = init_synthetic(cfg, seed=TP_TRAIN["seed"])
    step1, init1 = trainer.make_train_step(cfg, lr=TP_TRAIN["lr"])
    step4, init4 = trainer.make_train_step(cfg, lr=TP_TRAIN["lr"],
                                           mesh=make_mesh(1, 4, devices=["cuda:0"] * 4))
    p1, o1 = init1(weights, dev)
    p4, o4 = init4(weights)
    was = torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled()
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        secs["training set-up"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        zero_counts()
        losses1 = [float(step1(p1, o1, *batch)) for _ in range(steps)]
        counts1 = {k: fn.launches for k, fn in launch_counters().items() if fn.launches}
        secs["one device's steps"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        zero_counts()
        losses4 = [float(step4(p4, o4, *batch)) for _ in range(steps)]
        secs["(1, 4) steps"] = time.perf_counter() - t0
        counts4 = check_counts("tp training (1, 4)", counts1)
    finally:
        torch.backends.cudnn.deterministic = was[0]
        torch.use_deterministic_algorithms(was[1])
    rel = [abs(a - b) / abs(b) for a, b in zip(losses4, losses1)]
    same, moments = 0, 0
    plain = dict(trainer.tree_leaves(p1))
    for key, leaf in trainer.tree_leaves(p4[0]):
        ts = leaf_tensors(leaf)
        whole = [torch.cat([(t if m is None else o4.state[t][m]).detach() for t in ts], dim=-1)
                 for m in (None, "exp_avg", "exp_avg_sq")]
        want = [plain[key].detach(), o1.state[plain[key]]["exp_avg"],
                o1.state[plain[key]]["exp_avg_sq"]]
        same += all(torch.equal(x, y) for x, y in zip(whole, want))
        for t in ts:
            st = o4.state[t]
            if st["exp_avg"].shape != t.shape or st["exp_avg_sq"].device != t.device:
                raise AssertionError(f"tp training: {key}'s moments are not its shards'")
            moments += 1
    log(f"tp training (1, 4) on cuda:0 x 4, torch's deterministic algorithms: {steps} steps of "
        f"batch {B}, {TP_TRAIN['blocks']} blocks, losses {losses4} vs one device {losses1} "
        f"(relative {max(rel):.2e}); {same} of {len(plain)} leaves bit-equal with both Adam "
        f"moments; {moments} shard moments beside their shards; launches {json.dumps(counts4)} "
        f"[{card}]")
    if max(rel) > 1e-5 or same != len(plain):
        raise AssertionError(f"tp training: losses relative {rel}, {same} of {len(plain)} "
                             "leaves bit-equal")
    runs["r941_native_tp_train"] = counts4
    log("tp step seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return runs


def library_refs(np):
    """The long reads of the library step and the port's CPU runs of
    basecall_read_chunked on them, started on a thread of their own
    (main() starts it beside the kernels' builds, which leave cores idle
    behind their longest nvcc): (reads, a future of [(result,
    seconds)])."""
    from concurrent.futures import ThreadPoolExecutor

    from flappie_tpu_torch.basecall import Basecaller
    from flappie_tpu_torch.signal.preprocess import RawTable
    from flappie_tpu_torch.signal.synthetic import synthetic_adc

    rng = np.random.default_rng(31)
    reads = []
    for k, n in enumerate(LIBRARY_READS):
        adc = synthetic_adc(n, rng)
        cal = (np.float32(4.0), np.float32(0.18))
        raw = ((adc.astype(np.float32) + cal[0]) * cal[1]).astype(np.float32)
        reads.append(RawTable(f"long-{k}", n, 0, n, raw, adc=adc, cal=cal))
    cpu = Basecaller(device="cpu")

    def run():
        out = []
        for rt in reads:
            t0 = time.perf_counter()
            out.append((cpu.basecall_read_chunked(rt, *LIBRARY_CHUNK), time.perf_counter() - t0))
        return out

    pool = ThreadPoolExecutor(1, thread_name_prefix="library-cpu")
    try:
        return reads, pool.submit(run)
    finally:
        pool.shutdown(wait=False)


def library_phase(torch, np, card: str, reads_dir: str, names: list, refs: tuple) -> dict:
    """The Basecaller's per-batch entries (module docstring, phase 3's
    library) against ``refs`` (library_refs); returns the runs' launch
    counts."""
    from flappie_tpu_torch.basecall import (Basecaller, _device_basecall_packed,
                                            _unpack_chunk_outputs, bucket_length,
                                            pack_chunk_inputs, preprocess_batch)
    from flappie_tpu_torch.parallel.chunking import plan_chunks

    caller = Basecaller()
    cfg = caller.cfg
    pre = preprocess_batch(read_raws(reads_dir, names))
    segs = [rt.active() for rt in pre if rt is not None and rt.end - rt.start <= caller.chunk][:8]
    if len(segs) != 8:
        raise AssertionError(f"library: {len(segs)} short reads, expected 8")
    bucket = bucket_length(max(s.size for s in segs))
    sig = np.zeros((8, bucket), np.float32)
    lengths = np.array([s.size for s in segs], np.int32)
    for j, s in enumerate(segs):
        sig[j, : s.size] = s
    zero_counts()
    got = caller.call_batch(sig, lengths)
    runs = {"r941_native_call_batch": {k: fn.launches for k, fn in launch_counters().items()
                                       if fn.launches}}
    z = np.zeros(8, np.int32)
    with torch.inference_mode():
        out = _device_basecall_packed(caller.params,
                                      torch.from_numpy(pack_chunk_inputs(sig, lengths, z, z)).cuda(),
                                      cfg, caller.temperature, False, True)
    want = _unpack_chunk_outputs(out.cpu().numpy(), -(-bucket // cfg.total_stride) + 1,
                                 cfg.nstate, True)
    for name, a, b in zip(("score", "path", "qchar", "nblocks", "trace"), got, want):
        if a.shape != b.shape or not np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                                                    np.ascontiguousarray(b).view(np.uint8)):
            raise AssertionError(f"library call_batch: {name} differs from the bucket program's")
    log(f"library call_batch: 8 reads in bucket {bucket}, every output byte-equal to the f32 "
        f"bucket program's; launches {json.dumps(runs['r941_native_call_batch'])}")

    chunk, overlap = LIBRARY_CHUNK
    got_recs, want_recs, results = {}, {}, []
    reads, pending = refs
    for rt in reads:
        n = rt.n
        zero_counts()
        t0 = time.perf_counter()
        res = caller.basecall_read_chunked(rt, chunk, overlap)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = check_counts(f"library basecall_read_chunked {n} samples",
                              {"lstm_layer": 5, **FB_CRF})
        results.append((rt, res, wall, counts))
    for (rt, res, wall, counts), (ref, cpu_wall) in zip(results, pending.result()):
        n = rt.n
        if res is None or ref is None or res.nblock != ref.nblock:
            raise AssertionError(f"library basecall_read_chunked {n}: no call or another length")
        # (sequence, the header's normalised score, the record's bytes)
        got_recs[rt.uuid] = (res.basecall, res.score / res.nblock,
                             res.basecall + "\n" + res.quality)
        want_recs[rt.uuid] = (ref.basecall, ref.score / ref.nblock,
                              ref.basecall + "\n" + ref.quality)
        runs[f"r941_native_chunked_{n}"] = counts
        nchunk = plan_chunks(res.trim_end - res.trim_start, cfg.total_stride, chunk,
                             overlap).nchunk
        log(f"library basecall_read_chunked: {n} samples, {nchunk} chunks in one forward "
            f"batch, one stitched row of {res.nblock} blocks, "
            f"{len(res.basecall)} bases; card {wall:.3f} s, the port's CPU {cpu_wall:.1f} s (on "
            f"a thread beside the builds); "
            f"launches {json.dumps(counts)} [{card}]")
    compare_fastq("library basecall_read_chunked, card vs the port's CPU", got_recs, want_recs)
    return runs


# the dispatch step: the Basecaller's public packed-dispatch entries on
# r941_native at bench.py's geometry -- chunk batches of 256 x 12,800
# samples (2,560 blocks), full-read batches of 64 reads x 65,536 samples
# (13,108 blocks) -- and G batches a grouped entry (bench.py's G)
DISPATCH_CHUNK = (256, 12_800)
DISPATCH_FULL = (64, 65_536)
DISPATCH_G = 3
# entries by family: (entry, wire, grouped)
DISPATCH_ENTRIES = {
    "chunk": (("dispatch_packed_chunk", "f32", False), ("dispatch_packed_chunk_i16", "i16", False),
              ("dispatch_packed_chunk_d8", "d8", False),
              ("dispatch_packed_chunk_grouped", "f32", True),
              ("dispatch_packed_chunk_i16_grouped", "i16", True),
              ("dispatch_packed_chunk_d8_grouped", "d8", True)),
    "full": (("dispatch_packed_batch", "f32", False), ("dispatch_packed_batch_i16", "i16", False),
             ("dispatch_packed_batch_d8", "d8", False),
             ("dispatch_packed_batch_i16_grouped", "i16", True),
             ("dispatch_packed_batch_d8_grouped", "d8", True)),
}
# each entry's private program, by family and wire (single, grouped)
DISPATCH_PROGRAMS = {
    ("chunk", "f32"): ("_device_basecall_chunk_packed", "_device_basecall_chunk_packed_grouped"),
    ("chunk", "i16"): ("_device_basecall_chunk_packed_i16",
                       "_device_basecall_chunk_packed_i16_grouped"),
    ("chunk", "d8"): ("_device_basecall_chunk_packed_d8",
                      "_device_basecall_chunk_packed_d8_grouped"),
    ("full", "f32"): ("_device_basecall_packed", None),
    ("full", "i16"): ("_device_basecall_packed_i16", "_device_basecall_packed_i16_grouped"),
    ("full", "d8"): ("_device_basecall_packed_d8", "_device_basecall_packed_d8_grouped"),
}


def dispatch_batches(np, rng, rows: int, width: int, chunk: bool) -> list:
    """DISPATCH_G batches of ``rows`` x ``width`` ADC whose steps past int8
    are as rare as a real signal's (every row fits its d8 slots), each
    packed on the three wires: [{"f32", "i16", "d8": buffer, "args": the
    f32 wire's (signal, lengths, qlo, qhi), "samples": valid samples}].
    Chunk rows are full and own their whole range; full-read rows are
    ragged, the first full.  The f32 signal is the i16 program's
    normalisation done on the host, in the same float32 operations."""
    from flappie_tpu_torch.basecall import Basecaller, _encode_d8_np
    from flappie_tpu_torch.signal.synthetic import synthetic_adc

    raw_unit = np.float32(1373.41) / np.float32(8192.0)
    out = []
    for _ in range(DISPATCH_G):
        lengths = np.full(rows, width, np.int32)
        if not chunk:
            lengths[1:] = rng.integers(width // 4, width + 1, rows - 1)
        adc = np.zeros((rows, width), np.int16)
        sig = np.zeros((rows, width), np.float32)
        scal = np.zeros((rows, 4), np.float32)
        for j, n in enumerate(lengths):
            adc[j, :n] = synthetic_adc(int(n), rng, mean_dwell=30.0)
            pa = (adc[j, :n].astype(np.float32) + np.float32(16.0)) * raw_unit
            med = np.float32(np.median(pa))
            mad = np.float32(np.median(np.abs(pa - med))) * np.float32(1.4826)
            scal[j] = (16.0, raw_unit, med, mad)
            sig[j, :n] = (pa - med) / mad
        z = np.zeros(rows, np.int32)
        qlo, qhi = (np.ones(rows, np.int32), lengths // 5) if chunk else (z, z)
        i16 = Basecaller.pack_chunk_inputs_i16(adc, lengths, qlo, qhi, scal)
        d8 = _encode_d8_np(i16)
        if d8 is None:
            raise AssertionError("dispatch: a batch's rows overflow their d8 exception slots")
        out.append({"f32": Basecaller.pack_chunk_inputs(sig, lengths, qlo, qhi), "i16": i16,
                    "d8": d8, "args": (sig, lengths, qlo, qhi), "samples": int(lengths.sum())})
    return out


def hold_rows(np, what: str, got, want, cfg, T1: int) -> int:
    """Each row of the output bytes ``got`` within the GPU band of
    ``want``'s (identity >= 99.5% of the basecall, |score delta| <= 1e-4
    normalised by the row's blocks, as the FASTQ header's score); a
    byte-equal row passes as it is.  Logs and returns the byte-equal
    rows."""
    from flappie_tpu_torch.basecall import _unpack_chunk_outputs
    from flappie_tpu_torch.decode.seq import path_to_basecall

    if got.shape != want.shape:
        raise AssertionError(f"{what}: outputs {got.shape}, expected {want.shape}")
    same = (got == want).all(axis=1)
    gs, gp, gq, gn, _ = _unpack_chunk_outputs(got, T1, cfg.nstate, False)
    ws, wp, wq, wn, _ = _unpack_chunk_outputs(want, T1, cfg.nstate, False)
    worst_id, worst_ds = 1.0, 0.0
    for j in np.flatnonzero(~same):
        a = path_to_basecall(gp[j], gq[j], int(gn[j]), cfg.nbase)[0]
        b = path_to_basecall(wp[j], wq[j], int(wn[j]), cfg.nbase)[0]
        ident = identity(a, b)
        ds = abs(float(gs[j]) / max(int(gn[j]), 1) - float(ws[j]) / max(int(wn[j]), 1))
        worst_id, worst_ds = min(worst_id, ident), max(worst_ds, ds)
        if not (ident >= 0.995 and ds <= 1e-4 and gn[j] == wn[j]):
            raise AssertionError(f"{what} row {j}: outside the band (identity {ident}, score "
                                 f"delta {ds}, blocks {gn[j]} against {wn[j]})")
    log(f"{what}: {len(same)} rows, {int(same.sum())} byte-equal, min identity "
        f"{worst_id:.6f}, max |score delta| {worst_ds:.2e}")
    return int(same.sum())


def dispatch_phase(torch, np, card: str) -> dict:
    """The Basecaller's packed-dispatch entries (module docstring, phase 3's
    dispatch); returns the entries' launch counts by run name."""
    from flappie_tpu_torch import basecall as bc
    from flappie_tpu_torch.parallel.mesh import make_mesh
    from flappie_tpu_torch.parallel.pipeline import DistributedBasecaller

    G = DISPATCH_G
    caller = bc.Basecaller(compute_trace=False)  # bench.py's Basecaller
    cfg = caller.cfg
    rng = np.random.default_rng(20261018)
    t0 = time.perf_counter()
    fams = {"chunk": dispatch_batches(np, rng, *DISPATCH_CHUNK, True),
            "full": dispatch_batches(np, rng, *DISPATCH_FULL, False)}
    log(f"dispatch: {G} chunk batches of {DISPATCH_CHUNK[0]} x {DISPATCH_CHUNK[1]} and {G} "
        f"full-read batches of {DISPATCH_FULL[0]} x {DISPATCH_FULL[1]} (ragged; valid samples "
        f"{[b['samples'] for b in fams['full']]}) packed on the f32, i16 and d8 wires in "
        f"{time.perf_counter() - t0:.2f} s")
    T1s = {"chunk": caller.chunk // cfg.total_stride + 1,
           "full": -(-DISPATCH_FULL[1] // cfg.total_stride) + 1}
    if T1s["chunk"] != DISPATCH_CHUNK[1] // cfg.total_stride + 1:
        raise AssertionError(f"dispatch: the Basecaller's chunk {caller.chunk} is not the batches'")
    one = {"lstm_layer": 5, **FB_CRF}
    runs, refs, singles_of = {}, {}, {}

    def private(name, buf, *extra):
        fn = getattr(bc, name)
        dev = torch.from_numpy(buf).cuda()
        with torch.inference_mode():
            out, ms = event_ms(torch, lambda: fn(caller.params, dev, *extra, cfg,
                                                 caller.temperature, False, False))
        return out.cpu().numpy(), ms

    def entry(name, args, batches, what):
        """One entry run from an idle card to np.asarray, counted."""
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        handle = getattr(caller, name)(*args)
        t_ret = time.perf_counter() - t0
        out = np.asarray(handle)
        wall = time.perf_counter() - t0
        runs[f"r941_native_{what}"] = check_counts(
            f"dispatch {name}", {k: v * batches for k, v in one.items()})
        return handle, out, t_ret, wall

    for fam, bufs in fams.items():
        T1 = T1s[fam]
        # the private programs on the first batch (a first call warms the
        # allocator), timed on the device alone
        private(DISPATCH_PROGRAMS[fam, "i16"][0], bufs[0]["i16"])
        ref = refs[fam] = {}
        for wire in ("f32", "i16", "d8"):
            ref[wire] = private(DISPATCH_PROGRAMS[fam, wire][0], bufs[0][wire])
        singles = {}
        for name, wire, grouped in DISPATCH_ENTRIES[fam]:
            if grouped:
                continue
            _, out, t_ret, wall = entry(name, (bufs[0][wire],), 1, f"dispatch_{fam}_{wire}")
            want, ms = ref[wire]
            if not np.array_equal(out, want):
                raise AssertionError(f"dispatch {name}: not byte-equal to "
                                     f"{DISPATCH_PROGRAMS[fam, wire][0]} on the same buffer")
            singles[wire] = out
            n = bufs[0]["samples"]
            log(f"dispatch {name}: byte-equal to {DISPATCH_PROGRAMS[fam, wire][0]}; returned in "
                f"{t_ret * 1e3:.1f} ms, wall to np.asarray {wall * 1e3:.1f} ms = "
                f"{n / wall / 1e6:.3f} Msamples/s, the program device-only {ms:.1f} ms = "
                f"{n / ms / 1e3:.3f} Msamples/s [{card}]")
        if not np.array_equal(singles["d8"], singles["i16"]):
            raise AssertionError(f"dispatch {fam}: the d8 entry's bytes are not the i16 entry's")
        log(f"dispatch {fam}: the d8 entry byte-equal to the i16 entry on the same ADC")
        hold_rows(np, f"dispatch {fam}: the f32 entry against the i16 entry on the same reads",
                  singles["f32"], singles["i16"], cfg, T1)
        # the singles of the groups' other batches (the d8 groups are held to
        # the i16 singles: the d8 entry gives the i16 entry's bytes)
        per = {}
        for wire in ("f32", "i16") if fam == "chunk" else ("i16",):
            name = DISPATCH_ENTRIES[fam][("f32", "i16").index(wire)][0]
            per[wire] = [singles[wire]] + [np.asarray(getattr(caller, name)(b[wire]))
                                           for b in bufs[1:]]
        per["d8"] = per["i16"]
        singles_of[fam] = per
        n = sum(b["samples"] for b in bufs)
        for name, wire, grouped in DISPATCH_ENTRIES[fam]:
            if not grouped:
                continue
            buf = np.concatenate([b[wire] for b in bufs])
            gname = DISPATCH_PROGRAMS[fam, wire][1]
            _, ms = private(gname, buf, G)
            handle, out, t_ret, wall = entry(name, (buf, G), G, f"dispatch_{fam}_{wire}_g{G}")
            if not np.array_equal(out, np.concatenate(per[wire])):
                raise AssertionError(f"dispatch {name}: not byte-equal to its {G} batches' "
                                     f"single dispatches")
            if not np.array_equal(np.asarray(handle), handle.result()):
                raise AssertionError(f"dispatch {name}: np.asarray(handle) is not result()")
            log(f"dispatch {name} (G={G}): byte-equal to the {G} batches' single "
                f"{'i16 ' if wire == 'd8' else ''}dispatches, np.asarray(handle) = "
                f"handle.result(); returned in {t_ret * 1e3:.1f} ms, wall to np.asarray "
                f"{wall * 1e3:.1f} ms = {n / wall / 1e6:.3f} Msamples/s, {gname} device-only "
                f"{ms:.1f} ms = {n / ms / 1e3:.3f} Msamples/s [{card}]")

    # call_chunk_batch_device + unpack_chunk_outputs on the first chunk batch
    b0 = fams["chunk"][0]
    zero_counts()
    t0 = time.perf_counter()
    handle = caller.call_chunk_batch_device(*b0["args"])
    fields = caller.unpack_chunk_outputs(handle)
    wall = time.perf_counter() - t0
    runs["r941_native_dispatch_call_chunk"] = check_counts("dispatch call_chunk_batch_device", one)
    want = refs["chunk"]["f32"][0]
    for label, a, b in zip(("score", "path", "qchar", "nblocks"), fields,
                           bc._unpack_chunk_outputs(want, T1s["chunk"], cfg.nstate, False)):
        if not np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                              np.ascontiguousarray(b).view(np.uint8)):
            raise AssertionError(f"dispatch call_chunk_batch_device: {label} differs from "
                                 f"_device_basecall_chunk_packed's")
    log(f"dispatch call_chunk_batch_device + unpack_chunk_outputs: every field byte-equal to "
        f"_device_basecall_chunk_packed's on the same batch; wall {wall * 1e3:.1f} ms [{card}]")

    # the entries through the mesh: two replicas on the one card
    mesh = DistributedBasecaller(mesh=make_mesh(2, devices=list(MESH_DEVICES)),
                                 compute_trace=False)
    try:
        chunk = fams["chunk"]
        zero_counts()
        got = np.asarray(mesh.dispatch_packed_chunk_i16(chunk[0]["i16"]))
        runs["r941_native_dispatch_mesh"] = check_counts(
            "dispatch mesh dispatch_packed_chunk_i16", {k: 2 * v for k, v in one.items()})
        zero_counts()
        got_g = np.asarray(mesh.dispatch_packed_chunk_i16_grouped(
            np.concatenate([b["i16"] for b in chunk]), G))
        runs[f"r941_native_dispatch_mesh_g{G}"] = check_counts(
            "dispatch mesh dispatch_packed_chunk_i16_grouped",
            {k: 2 * G * v for k, v in one.items()})
        summary = mesh.wire_summary()
    finally:
        mesh.close()
    if len(summary) != 2 or any(ent["devices"] != [2] for ent in summary.values()):
        raise AssertionError(f"dispatch mesh: not two programs on two devices: {summary}")
    ones = singles_of["chunk"]["i16"]
    hold_rows(np, f"dispatch mesh over {list(MESH_DEVICES)}: dispatch_packed_chunk_i16 against "
              f"one device", got, ones[0], cfg, T1s["chunk"])
    hold_rows(np, f"dispatch mesh: dispatch_packed_chunk_i16_grouped (G={G}) against one "
              f"device's singles", got_g, np.concatenate(ones), cfg, T1s["chunk"])
    log(f"dispatch mesh: wire_summary {json.dumps(summary)}")
    return runs


def launch_phase(torch, card: str, reads_dir: str, names: list) -> None:
    """python -m flappie_tpu_torch.parallel.launch --nproc 2 with --trace,
    both workers on cuda:0, against the CLI in this process."""
    wdir = os.path.join(WORK, "launch")
    os.makedirs(wdir)
    merged, trace = os.path.join(wdir, "merged.fastq"), os.path.join(wdir, "merged.h5")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)}
    cmd = [sys.executable, "-m", "flappie_tpu_torch.parallel.launch", "--nproc", "2",
           "--partdir", wdir, "--", reads_dir, "-o", merged, "--trace", trace]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"launch --nproc 2 exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    plain, plain_trace = os.path.join(wdir, "plain.fastq"), os.path.join(wdir, "plain.h5")
    plain_wall = run_cli(torch, [reads_dir, "-o", plain, "--trace", plain_trace])
    with open(merged) as fh:
        got = parse_fastq(fh.read(), "ACGT")
    with open(plain) as fh:
        want = parse_fastq(fh.read(), "ACGT")
    if list(got) != list(want):
        raise AssertionError(f"launch --nproc 2: the merged records are not in input order: "
                             f"{list(got)} against {list(want)}; the launcher's stderr:\n"
                             f"{proc.stderr[-3000:]}")
    compare_fastq("launch --nproc 2 (both workers on cuda:0) vs one process", got, want)
    compare_traces(trace, plain_trace, {rec[3]["uuid"] for rec in want.values()},
                   "launch --nproc 2 vs one process", same_groups=True)
    if os.path.exists(trace + ".part0") or any(f.startswith("flappie_part")
                                               for f in os.listdir(wdir)):
        raise AssertionError("launch --nproc 2: part files left behind")
    log(f"launch --nproc 2: {len(names)} reads, wall {wall:.3f} s (two worker processes, each "
        f"starting torch and its weights on the card, and the merge) vs one process in this "
        f"process {plain_wall:.3f} s; worker launches not counted (processes of their own) "
        f"[{card}]")


def dp_train_phase(torch, np, card: str) -> dict:
    """Two training ranks over gloo on the one card
    (flappie_tpu_torch.train.distributed), each with half of r941_native's
    training batch, against one process taking the same steps on the
    whole batch; returns the one-process run's launch counts."""
    from flappie_tpu_torch.models.config import get_model_config
    from flappie_tpu_torch.models.params import init_synthetic
    from flappie_tpu_torch.train import trainer

    out = os.path.join(WORK, "dp")
    args = ["--nproc", str(DP["nproc"]), "--steps", str(DP["steps"]), "--batch",
            str(DP["batch"]), "--blocks", str(DP["blocks"]), "--seed", str(DP["seed"]),
            "--lr", str(DP["lr"]), "--device", "cuda:0", "--backend", "gloo", "--out", out]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "flappie_tpu_torch.train.distributed"] + args,
                          cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"dp-train exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])

    cfg = get_model_config("r941_native")
    dev = torch.device("cuda")
    batch = [torch.from_numpy(a).to(dev) for a in trainer.synthetic_batch(
        cfg, DP["batch"], DP["blocks"] * cfg.total_stride, DP["seed"])]
    step, init = trainer.make_train_step(cfg, lr=DP["lr"])
    params, opt = init(init_synthetic(cfg, seed=DP["seed"]), dev)
    zero_counts()
    losses, secs = [], []
    for _ in range(DP["steps"]):
        t1 = time.perf_counter()
        losses.append(float(step(params, opt, *batch)))
        secs.append(time.perf_counter() - t1)
    counts = check_counts(f"dp-train one process, {DP['steps']} steps",
                          {"lstm_layer_train": 5 * DP["steps"], "crf_sum_scan": 2 * DP["steps"]})
    rel = [abs(a - b) / abs(b) for a, b in zip(summary["losses"], losses)]
    want_rank = {"lstm_layer_train": 5 * DP["steps"], "lstm_layer_train_bf16": 0,
                 "grumod_layer": 0, "crf_sum_scan": 2 * DP["steps"]}
    log(f"dp-train: 2 ranks over gloo on cuda:0, rows {summary['rows']}, {DP['blocks']} blocks, "
        f"losses {summary['losses']} vs one process {losses} (relative {max(rel):.2e}); ranks' "
        f"parameters equal after every step: {summary['ranks_equal']}; step walls "
        f"{[[round(x, 3) for x in r] for r in summary['step_s']]} s by rank vs one process "
        f"{[round(x, 3) for x in secs]} s; process wall {wall:.1f} s; launches a rank "
        f"{summary['launches']}, one process {json.dumps(counts)} [{card}]")
    if not summary["ranks_equal"]:
        raise AssertionError("dp-train: the ranks' parameters differ")
    if summary["rows"] != [DP["batch"] // 2] * 2 or max(rel) > 1e-5:
        raise AssertionError(f"dp-train: rows {summary['rows']}, losses relative {rel}")
    if any(r != want_rank for r in summary["launches"]):
        raise AssertionError(f"dp-train: rank launches {summary['launches']}, expected "
                             f"{want_rank} each")
    return counts


def profile_phase(torch, card: str, reads_dir: str) -> None:
    """The CLI with --jax-profile DIR: a Chrome trace naming the path's
    kernels, and the FASTQ of the run without the flag."""
    import glob

    pdir = os.path.join(WORK, "profile")
    plain, profiled = os.path.join(pdir, "plain.fastq"), os.path.join(pdir, "profiled.fastq")
    os.makedirs(pdir)
    plain_wall = run_cli(torch, [reads_dir, "-o", plain])
    wall = run_cli(torch, [reads_dir, "-o", profiled, "--jax-profile", pdir])
    with open(plain, "rb") as a, open(profiled, "rb") as b:
        if a.read() != b.read():
            raise AssertionError("--jax-profile changed the FASTQ bytes")
    traces = glob.glob(os.path.join(pdir, "flappie.*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"--jax-profile: trace files {traces}")
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    missing = [k for k in PROFILE_KERNELS if not any(k in name for name in kernels)]
    if missing:
        raise AssertionError(f"--jax-profile: the trace names no {missing} among "
                             f"{sorted(kernels)[:20]}")
    log(f"profile: --jax-profile wrote {os.path.basename(traces[0])} "
        f"({os.path.getsize(traces[0])} bytes, {len(events)} events, {len(kernels)} kernel "
        f"names, {list(PROFILE_KERNELS)} among them), FASTQ byte-equal to the run without it; "
        f"wall {wall:.3f} s with the profiler vs {plain_wall:.3f} s [{card}]")


def multi_phase(torch, np, card: str, refs: tuple) -> dict:
    """The mesh (and its model axis), the library entries, the launcher,
    data-parallel training and --jax-profile runs; returns their
    in-process launch counts by run name.  ``refs``: library_refs,
    started beside the builds."""
    reads_dir, names = mesh_reads()
    log(f"multi-device phases: {len(names)} of phase 3's r941_native reads ({names})")
    launches = mesh_phase(torch, card, reads_dir, names)
    launches.update(timed("tp_phase", tp_phase, torch, np, card, reads_dir, names))
    launches.update(timed("library_phase", library_phase, torch, np, card, reads_dir, names,
                          refs))
    launches.update(timed("dispatch_phase", dispatch_phase, torch, np, card))
    # the worker processes below share the card with this one: hand back
    # the blocks its caching allocator keeps from the earlier phases
    held = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    log(f"multi-device phases: this process's reserved device memory {held / 2**30:.2f} GiB, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB after empty_cache, before the worker "
        f"processes")
    launch_phase(torch, card, reads_dir, names)
    launches["r941_native_dp_train"] = dp_train_phase(torch, np, card)
    profile_phase(torch, card, reads_dir)
    return launches


# -- phase 3, the JAX package's other knobs ------------------------------------

# fb runs of the knobs phase, each against the default fb run on the mesh
# reads: (name, environment, the rule: "bytes" for byte-equal, "band" for
# compare_fastq's band, "bytes_or_band" for byte-equal or the band with the
# reason logged)
KNOB_PHASE_RUNS = (
    ("crf_seg", {"FLAPPIE_TPU_CRF_IMPL": "seg"}, "band"),
    ("crf_scan", {"FLAPPIE_TPU_CRF_IMPL": "scan"}, "band"),
    ("upload_d8", {"FLAPPIE_TPU_UPLOAD": "d8"}, "bytes"),
    ("upload_f32", {"FLAPPIE_TPU_UPLOAD": "f32"}, "bytes_or_band"),
    ("dispatch_group_2", {"FLAPPIE_TPU_DISPATCH_GROUP": "2"}, "bytes"),
    # once more: is the first grouped run's extra wall a cost paid once?
    ("dispatch_group_2_again", {"FLAPPIE_TPU_DISPATCH_GROUP": "2"}, "bytes"),
    ("threads", {"FLAPPIE_TPU_UPLOAD_THREADS": "1", "FLAPPIE_TPU_COLLECT_THREAD": "1"}, "bytes"),
    ("prewarm", {"FLAPPIE_TPU_PREWARM": "1"}, "bytes"),
    ("preprocess_wave_4", {"FLAPPIE_TPU_PREPROCESS_WAVE": "4"}, "bytes"),
    ("scanb_plain", {"FLAPPIE_TPU_SCANB_KERNELS": "off"}, "band"),
)
# the CRF kernels of the batch-minor decode, silent under seg, scan and the
# plain batch-minor scans
CRF_KERNELS = ("crf_sum_scan", "crf_fwdbwd", "crf_viterbi", "crf_traceback", "crf_bt_fwd",
               "crf_bt_viterbi", "crf_bt_traceback")
# reads whose steps past int8 are as rare as a real signal's (~0.5% of the
# deltas, events of ~30 samples): two long, two short, so that the d8
# programs of both paths run (most rows of the main paths' reads, ~1.6%,
# overflow their slots and take the i16 wire)
D8_READS = ((2, 60_000, 80_000), (2, 6_000, 12_000))
# runnie's reads run under seg, and the least of them that meet the strict
# rule against the default impl: on the CPU, tools/torch_runnie_seg_witness.py
# finds 4 of these 8 for the port's seg against its scan, 5 against its
# scanb, and 6 for the JAX package's seg against its own scan
RUNNIE_SEG_READS = 8
RUNNIE_SEG_STRICT = 4


def knob_cli(torch, what: str, args: list, env: dict, main=None, phases=None):
    """One CLI run under ``env``, every launch counter zeroed before it,
    its phase dump written to ``phases`` when given: (wall, launch counts,
    the Basecaller's dispatch_stats or None)."""
    from flappie_tpu_torch.cli import flappie as cli

    callers = []
    make = cli.make_caller

    def capture(a):
        caller = make(a)
        callers.append(caller)
        return caller

    cli.make_caller = capture
    try:
        zero_counts()
        with phases_to(phases):
            wall = run_cli(torch, args, main, env)
    finally:
        cli.make_caller = make
    counts = {k: fn.launches for k, fn in launch_counters().items() if fn.launches}
    return wall, counts, (dict(callers[0].dispatch_stats) if callers else None)


def knob_run(torch, card: str, name: str, env: dict, rule: str, reads_dir: str, want_text: str,
             base: dict, extra=()) -> float:
    """One knob's fb (or ``extra``) run on the mesh reads, held to the
    default run by ``rule``; the launch counts checked against the
    default's; returns the wall."""
    out = os.path.join(WORK, "knobs", f"{name}.fastq")
    phases = (os.path.join(WORK, "knobs", f"{name}.phases.json")
              if name.startswith("dispatch_group") else None)
    wall, counts, stats = knob_cli(torch, name, [reads_dir, "-o", out] + list(extra), env,
                                   phases=phases)
    if phases:
        log_phases(f"knob {name}", phases, wall, card)
    with open(out) as fh:
        text = fh.read()
    got, want = parse_fastq(text, "ACGT"), parse_fastq(want_text, "ACGT")
    same = text == want_text
    if rule == "bytes" and not same:
        raise AssertionError(f"knob {name} ({env}): the FASTQ is not the default run's bytes")
    reason = ""
    if not same:
        compare_fastq(f"knob {name} vs the default run", got, want)
        if rule == "bytes_or_band":
            reason = (" (not byte-equal: the f32 wire normalises on the host, the i16 wire "
                      "on the card from the ADC counts)")
    layer = base["counts"].get("lstm_layer", 0)
    if env.get("FLAPPIE_TPU_CRF_IMPL") in ("seg", "scan") or env.get(
            "FLAPPIE_TPU_SCANB_KERNELS") == "off":
        if any(counts.get(k) for k in CRF_KERNELS) or counts.get("lstm_layer", 0) != layer:
            raise AssertionError(f"knob {name}: launches {counts}, expected {layer} K1 and no "
                                 "CRF kernel")
    elif name == "prewarm":
        # the prewarm batch is a program too
        if (layer and counts.get("lstm_layer", 0) <= layer) or any(
                counts.get(k, 0) < v for k, v in base["counts"].items()):
            raise AssertionError(f"knob {name}: launches {counts}, default {base['counts']}")
    elif counts != base["counts"]:
        raise AssertionError(f"knob {name}: launches {counts}, default {base['counts']}")
    log(f"knob {name} ({json.dumps(env)}): wall {wall:.3f} s vs the default {base['wall']:.3f} s; "
        f"{'byte-equal' if same else 'within the band'}{reason}; dispatches "
        f"{json.dumps(stats)}; launches {json.dumps(counts)} [{card}]")
    return stats


def knobs_mesh_run(torch, card: str, reads_dir: str, names: list, want_text: str) -> None:
    """DistributedBasecaller over MESH_DEVICES under d8 and a dispatch group
    of 2, against the one-device default run by the band."""
    from flappie_tpu_torch.parallel.mesh import make_mesh
    from flappie_tpu_torch.parallel.pipeline import DistributedBasecaller

    env = {"FLAPPIE_TPU_UPLOAD": "d8", "FLAPPIE_TPU_DISPATCH_GROUP": "2"}
    with knobs(env):
        mesh = DistributedBasecaller(mesh=make_mesh(2, devices=list(MESH_DEVICES)),
                                     compute_trace=False)
        try:
            zero_counts()
            got, wall = library_fastq(torch, mesh, read_raws(reads_dir, names), names)
            counts = {k: fn.launches for k, fn in launch_counters().items() if fn.launches}
            summary = mesh.wire_summary()
            stats = dict(mesh.dispatch_stats)
        finally:
            mesh.close()
    grouped = [k for k in summary if "_grouped[" in k]
    if not grouped or any(summary[k]["devices"] != [2] for k in grouped):
        raise AssertionError(f"knob mesh: no grouped dispatch over two shards: {summary}")
    got_recs, want_recs = parse_fastq(got, "ACGT"), parse_fastq(want_text, "ACGT")
    if list(got_recs) != list(want_recs):
        raise AssertionError("knob mesh: the records are not in the one-device order")
    compare_fastq("knob mesh 2 (d8, group 2) vs the one-device default run", got_recs, want_recs)
    log(f"knob mesh 2 over {list(MESH_DEVICES)} ({json.dumps(env)}): wall {wall:.3f} s; "
        f"dispatches {json.dumps(stats)}; wire summary {json.dumps(summary)}; launches "
        f"{json.dumps(counts)} [{card}]")


def knobs_d8_reads(torch, np, card: str) -> None:
    """FLAPPIE_TPU_UPLOAD=d8 on D8_READS, whose rows fit their exception
    slots: the d8 chunk and bucket programs run, byte-equal to the default
    run of the same reads."""
    wdir = os.path.join(WORK, "knobs", "d8")
    rng = np.random.default_rng(20261018)
    from flappie_tpu_torch.signal.fast5 import write_single_read_fast5
    from flappie_tpu_torch.signal.synthetic import synthetic_adc

    reads_dir = os.path.join(wdir, "reads")
    os.makedirs(reads_dir)
    sizes = [int(n) for count, lo, hi in D8_READS for n in rng.integers(lo, hi, count)]
    for k, n in enumerate(sizes):
        write_single_read_fast5(os.path.join(reads_dir, f"d8_{k}.fast5"),
                                synthetic_adc(n, rng, mean_dwell=30.0),
                                f"00000000-0000-4000-8000-{900 + k:012d}")
    texts, walls, stats = {}, {}, {}
    for mode, env in (("default", {}), ("d8", {"FLAPPIE_TPU_UPLOAD": "d8"})):
        out = os.path.join(wdir, f"{mode}.fastq")
        walls[mode], _, stats[mode] = knob_cli(torch, mode, [reads_dir, "-o", out], env)
        with open(out) as fh:
            texts[mode] = fh.read()
    if texts["d8"] != texts["default"]:
        raise AssertionError("knob upload_d8 on real-like reads: the FASTQ is not the i16 run's")
    want = {"_device_basecall_chunk_packed_d8", "_device_basecall_packed_d8"}
    if not want <= set(stats["d8"]):
        raise AssertionError(f"knob upload_d8: the d8 programs did not run: {stats['d8']}")
    log(f"knob upload_d8 on {len(sizes)} reads of real-like steps ({sizes} samples): byte-equal "
        f"to the i16 run; dispatches {json.dumps(stats['d8'])} vs {json.dumps(stats['default'])}; "
        f"wall {walls['d8']:.3f} s vs {walls['default']:.3f} s [{card}]")


def strict_runs(got: list, want: list) -> bool:
    """compare_runs' strict rule for one record: equal line for line, or
    base and dwell equal with shape and scale within 2e-5."""
    if len(got) != len(want):
        return False
    for a, b in zip(got, want):
        fa, fb = a.split("\t"), b.split("\t")
        if (fa[0], fa[3]) != (fb[0], fb[3]) or any(
                abs(float(fa[i]) - float(fb[i])) > 2e-5 for i in (1, 2)):
            return False
    return True


def knobs_runnie_seg(torch, card: str) -> None:
    """runnie fb under FLAPPIE_TPU_CRF_IMPL=seg on RUNNIE_SEG_READS of its
    reads against the default impl, each record held by its run bases
    (identity >= 99.5%, the flappie runs' band, and run count within 1%),
    and at least RUNNIE_SEG_STRICT records meeting the strict rule: seg's
    matrix products reassociate the f32 sums, and runnie's fb Viterbi over
    unnormalised posteriors of thousands of blocks follows near ties on
    the last bits, in the JAX package's seg too (the witness on the CPU:
    tools/torch_runnie_seg_witness.py)."""
    from flappie_tpu_torch.cli.runnie import main as runnie_main

    src = os.path.join(WORK, "rle_r941_native", "reads")
    sub = os.path.join(WORK, "knobs", "runnie", "reads")
    os.makedirs(sub)
    for n in sorted(os.listdir(src))[:RUNNIE_SEG_READS]:
        shutil.copy(os.path.join(src, n), sub)
    recs, walls = {}, {}
    for impl in ("auto", "seg"):
        out = os.path.join(WORK, "knobs", "runnie", f"{impl}.run")
        walls[impl], counts, _ = knob_cli(torch, impl, [sub, "-o", out],
                                          {"FLAPPIE_TPU_CRF_IMPL": impl}, runnie_main)
        with open(out) as fh:
            recs[impl] = parse_run(fh.read())
        if impl == "seg" and any(counts.get(k) for k in CRF_KERNELS):
            raise AssertionError(f"runnie seg: CRF kernels launched: {counts}")
    if len(recs["seg"]) != RUNNIE_SEG_READS:
        raise AssertionError(f"runnie seg: {len(recs['seg'])} records")
    compare_runs("knob runnie seg vs the default impl", recs["seg"], recs["auto"], loose=True)
    worst = min(identity("".join(x[0] for x in recs["seg"][u]),
                         "".join(x[0] for x in recs["auto"][u])) for u in recs["auto"])
    strict = sum(strict_runs(recs["seg"][u], recs["auto"][u]) for u in recs["auto"])
    if worst < 0.995 or strict < RUNNIE_SEG_STRICT:
        raise AssertionError(f"runnie seg: min run-base identity {worst}, {strict} records "
                             f"meet the strict rule (at least {RUNNIE_SEG_STRICT})")
    log(f"knob runnie seg: {RUNNIE_SEG_READS} reads, {strict} of them with base and dwell equal "
        f"and shape and scale within 2e-5; wall {walls['seg']:.3f} s vs the default "
        f"{walls['auto']:.3f} s [{card}]")


def knobs_native(np) -> None:
    """native.py on the 80 r941_native reads: the library builds, and
    preprocess_batch and encode_d8 are bit-equal to the numpy versions
    (each chunk-width row of each read's ADC encoded alone, so that rows
    that overflow and rows that fit both occur)."""
    from flappie_tpu_torch import basecall, native
    from flappie_tpu_torch.signal.fast5 import read_raw

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"native.py: the host library did not build:\n{native.build_log}")
    build_s = time.perf_counter() - t0
    src = os.path.join(WORK, "r941_native", "reads")
    reads = [read_raw(os.path.join(src, n)) for n in sorted(os.listdir(src))]
    t0 = time.perf_counter()
    got = native.preprocess_batch(reads)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = basecall.preprocess_batch(reads)
    numpy_s = time.perf_counter() - t0
    def norm(rt):
        return None if rt.norm is None else np.array(rt.norm, np.float32).tobytes()

    for a, b in zip(got, want):
        if (a is None) != (b is None) or (a is not None and not (
                (a.start, a.end) == (b.start, b.end) and a.raw.tobytes() == b.raw.tobytes()
                and norm(a) == norm(b))):
            raise AssertionError(f"native preprocess_batch differs from numpy on read {a or b}")
    want = [rt for rt in want if rt is not None and rt.adc is not None and rt.norm is not None]
    W, rows, fits, enc_s, fitting = 12_800, 0, 0, {"native": 0.0, "numpy": 0.0}, []
    for rt in want:
        adc = rt.adc[rt.start : rt.end]
        scal = np.array([[rt.cal[0], rt.cal[1], rt.norm[0], rt.norm[1]]], np.float32)
        for s in range(0, adc.size, W):
            seg = adc[s : s + W]
            row = np.zeros((1, W), np.int16)
            row[0, : seg.size] = seg
            z = np.zeros(1, np.int32)
            buf = basecall.pack_chunk_inputs_i16(row, np.array([seg.size], np.int32), z, z, scal)
            t0 = time.perf_counter()
            a = native.encode_d8(buf)
            t1 = time.perf_counter()
            b = basecall._encode_d8_np(buf)
            enc_s["native"] += t1 - t0
            enc_s["numpy"] += time.perf_counter() - t1
            if (a is None) != (b is None) or (a is not None and not np.array_equal(a, b)):
                raise AssertionError(f"native encode_d8 differs from numpy on {rt.uuid} at {s}")
            rows, fits = rows + 1, fits + (a is not None)
            if a is not None:
                fitting.append(buf)
    # the basecaller encodes a chunk batch at once: 256 rows that fit
    batch = np.concatenate(fitting[:256])
    batch_s = {}
    for name, fn in (("native", native.encode_d8), ("numpy", basecall._encode_d8_np)):
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(batch)
            runs.append(time.perf_counter() - t0)
        batch_s[name] = statistics.median(runs)
    log(f"native.py: built into {native.lib_path()} in {build_s:.2f} s; preprocess_batch "
        f"bit-equal to numpy on {len(reads)} reads ({native_s:.3f} s vs {numpy_s:.3f} s); "
        f"encode_d8 bit-equal on {rows} rows of {W} samples ({fits} fit their slots, "
        f"{rows - fits} overflow to None in both; a row at a time, {enc_s['native']:.3f} s vs "
        f"numpy's {enc_s['numpy']:.3f} s; a batch of {batch.shape[0]} rows, median of 5, "
        f"{batch_s['native']:.4f} s vs numpy's {batch_s['numpy']:.4f} s)")


def knobs_phase(torch, np, card: str) -> None:
    """The JAX package's other knobs on the mesh reads (phase 3's 16
    r941_native reads): each run of KNOB_PHASE_RUNS and seg under
    --viterbi against the default run in this call, the mesh under d8 and
    groups, d8 on reads whose rows fit, runnie under seg, native.py."""
    reads_dir = os.path.join(WORK, "mesh", "reads")
    names = sorted(os.listdir(reads_dir))
    os.makedirs(os.path.join(WORK, "knobs"))
    knobs_native(np)  # first: the d8 runs' walls then hold no g++ build
    base = {}
    for mode, extra in (("fb", []), ("viterbi", ["--viterbi"])):
        out = os.path.join(WORK, "knobs", f"default_{mode}.fastq")
        phases = os.path.join(WORK, "knobs", f"default_{mode}.phases.json")
        wall, counts, stats = knob_cli(torch, mode, [reads_dir, "-o", out] + extra, {},
                                       phases=phases)
        log_phases(f"knobs default {mode}", phases, wall, card)
        with open(out) as fh:
            base[mode] = {"text": fh.read(), "wall": wall, "counts": counts}
        log(f"knobs: default {mode} on {len(names)} reads: wall {wall:.3f} s; dispatches "
            f"{json.dumps(stats)}; launches {json.dumps(counts)} [{card}]")
    for name, env, rule in KNOB_PHASE_RUNS:
        stats = knob_run(torch, card, name, env, rule, reads_dir, base["fb"]["text"], base["fb"])
        if name == "upload_d8":
            log(f"knob upload_d8 on the mesh reads: {sorted(stats)} ran (a batch with a row past "
                "its slots takes the i16 wire)")
    knob_run(torch, card, "crf_seg_viterbi", {"FLAPPIE_TPU_CRF_IMPL": "seg"}, "band", reads_dir,
             base["viterbi"]["text"], base["viterbi"], ["--viterbi"])
    knobs_mesh_run(torch, card, reads_dir, names, base["fb"]["text"])
    knobs_d8_reads(torch, np, card)
    knobs_runnie_seg(torch, card)


# -- phase 4: training ---------------------------------------------------------

# tools/train_r5.py's recipe: batch 32, chunks of 2560 samples, Adam at lr
# 2e-4, a teacher init_synthetic(seed=0) labelling reads of 16k-28k
# samples with its Viterbi paths, a student init_synthetic(seed=7)
TRAIN = dict(batch=32, chunk=2560, lr=2e-4, steps=40, reads=(96, 16_000, 28_000))


def rel_err(got, want) -> float:
    """max |got - want| over max |want|: the gradient band's measure."""
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def check_gradients(torch, card: str) -> None:
    """The training path's autograd Functions against autograd through
    the plain versions on the card (T=512 blocks, B=32, IN=H=256), every
    gradient within 1e-3 of its max |value|; then the adjoint's backward
    of one layer timed next to cuDNN nn.LSTM's backward (a yardstick)."""
    from flappie_tpu_torch.ops import crf_bm_cuda, rnn_cuda, rnn_vjp
    from flappie_tpu_torch.ops.crf import crf_partition_ad, flipflop_index, lse
    from flappie_tpu_torch.ops.crf_bm import _dense_tm

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    T, B, IN, H = 512, 32, 256, 256
    lengths = torch.randint(1, T, (B,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = T, 0
    mask = (torch.arange(T, device=dev)[:, None] < lengths[None, :])[..., None]
    cot = torch.randn(T, B, H, generator=gen, device=dev)

    def layer_args(G, full=False):
        x = torch.randn(T, B, IN, generator=gen, device=dev)
        return [t.requires_grad_() for t in (
            x if full else x * mask, torch.randn(IN, G, generator=gen, device=dev) / IN ** 0.5,
            torch.randn(G, generator=gen, device=dev) * 0.2,
            torch.randn(H, G, generator=gen, device=dev) / H ** 0.5)]

    for kind, gates in (("lstm", 4), ("grumod", 3)):
        ad = getattr(rnn_vjp, f"{kind}_layer_tm_ad")
        plain = getattr(rnn_cuda, f"{kind}_layer_tm_plain")
        for backward in (False, True):
            args = layer_args(gates * H)
            got = torch.autograd.grad((ad(*args, backward, lengths) * cot).sum(), args)
            want = torch.autograd.grad((plain(*args, backward, lengths) * cot).sum(), args)
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            log(f"grad {kind}_layer_tm_ad (backward={backward}) vs autograd through the plain "
                f"layer: max |delta| / max |grad| dx {errs[0]:.2e}, diW {errs[1]:.2e}, "
                f"db {errs[2]:.2e}, dsW {errs[3]:.2e}")
            if not max(errs) <= 1e-3:
                raise AssertionError(f"{kind}_layer_tm_ad gradients outside 1e-3: {errs}")
    for nbase in (4, 5):
        idx = flipflop_index(nbase)
        trans = (torch.randn(B, T, idx.nparam, generator=gen, device=dev) * 2.0).requires_grad_()
        nblocks = lengths.to(torch.int64)
        g = torch.randn(B, generator=gen, device=dev)
        (got,) = torch.autograd.grad((crf_partition_ad(trans, nblocks, nbase) * g).sum(), [trans])
        tvalid = torch.arange(T, device=dev)[:, None] < nblocks[None, :]
        alphas = crf_bm_cuda.sum_states_plain(_dense_tm(trans.permute(1, 2, 0), idx), tvalid,
                                              False)
        final = alphas.gather(0, nblocks[None, None, :].expand(1, idx.nstate, B))[0]
        (want,) = torch.autograd.grad((lse(final, 0) * g).sum(), [trans])
        err = rel_err(got, want)
        log(f"grad crf_partition_ad S={idx.nstate} vs autograd through the plain scan: "
            f"max |delta| / max |grad| {err:.2e}")
        if not err <= 1e-3:
            raise AssertionError(f"crf_partition_ad S={idx.nstate} gradient outside 1e-3: {err}")

    # K10's Function (forward K10, backward the plain chain recomputed)
    # against autograd through the plain chain, B=32, T=2560 samples
    from flappie_tpu_torch.ops import conv_cuda

    Tc = 2560
    clen = torch.randint(1, Tc, (B,), generator=gen, device=dev, dtype=torch.int32)
    clen[0], clen[1] = Tc, 0
    x = torch.randn(B, Tc, generator=gen, device=dev)
    x = x * (torch.arange(Tc, device=dev) < clen[:, None])
    cargs = [t.requires_grad_() for t in (
        x, torch.randn(5, 1, 4, generator=gen, device=dev) * 0.5,
        torch.randn(4, generator=gen, device=dev) * 0.1,
        torch.randn(5, 4, 16, generator=gen, device=dev) * 0.3,
        torch.randn(16, generator=gen, device=dev) * 0.1)]
    ccot = torch.randn(B, 16, Tc, generator=gen, device=dev)
    got = torch.autograd.grad((conv_cuda.conv12_fused(*cargs, clen) * ccot).sum(), cargs)
    want = torch.autograd.grad((conv_cuda.conv12_fused_plain(*cargs, clen) * ccot).sum(), cargs)
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    log(f"grad conv12_fused (K10) vs autograd through the plain chain: max |delta| / max |grad| "
        f"dx {errs[0]:.2e}, dW1 {errs[1]:.2e}, db1 {errs[2]:.2e}, dW2 {errs[3]:.2e}, "
        f"db2 {errs[4]:.2e}")
    if not max(errs) <= 1e-3:
        raise AssertionError(f"conv12_fused gradients outside 1e-3: {errs}")

    # yardstick: the backward of one full-length LSTM layer, the adjoint
    # (one K8 forward kept) against cuDNN's backward on the same shape
    args = layer_args(4 * H, full=True)
    y = rnn_vjp.lstm_layer_tm_ad(*args)
    adj_ms = cuda_ms(torch, lambda: torch.autograd.grad(y, args, cot, retain_graph=True), 3)
    fwd_ms = cuda_ms(torch, lambda: rnn_vjp.lstm_layer_tm_ad(*args), 3)
    ref = torch.nn.LSTM(IN, H).to(dev)
    xr = args[0].detach().clone().requires_grad_()
    yr = ref(xr)[0]
    lib_ins = [xr] + list(ref.parameters())
    lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(yr, lib_ins, cot, retain_graph=True), 3)
    lib_fwd_ms = cuda_ms(torch, lambda: ref(xr), 3)
    log(f"backward of one LSTM layer at T={T}, B={B}, IN=H={H}: adjoint {adj_ms:.2f} ms "
        f"(its K8 forward {fwd_ms:.2f} ms); cuDNN nn.LSTM backward {lib_ms:.2f} ms "
        f"(forward {lib_fwd_ms:.2f} ms) [{card}]")


def supervised_chunks(np, cfg, segs, paths, chunk: int):
    """tools/train_r5.py's chunk_supervised: every whole chunk of each
    read with its block path slice [chunk/stride + 1]."""
    stride = cfg.total_stride
    chunk -= chunk % stride
    nblk = chunk // stride
    xs, ys = [], []
    for sig, path in zip(segs, paths):
        for s in range(0, sig.size - chunk + 1, chunk):
            xs.append(sig[s : s + chunk])
            ys.append(path[s // stride : s // stride + nblk + 1].astype(np.int32))
    return np.stack(xs), np.stack(ys)


# the f32 layers: each launch also counts its affine on affine_f32
F32_LAYERS = ("lstm_layer", "lstm_layer_train", "grumod_layer")


def check_counts(what: str, want: dict) -> dict:
    """Every counter equal to ``want`` (0 where it is silent; affine_f32,
    unless named, the f32 layers' launches)."""
    got = {k: fn.launches for k, fn in launch_counters().items()}
    full = dict.fromkeys(got, 0)
    full.update(want)
    if "affine_f32" not in want:
        full["affine_f32"] = sum(full[k] for k in F32_LAYERS)
    if got != full:
        raise AssertionError(f"{what}: kernel launches {got}, expected {full}")
    return got


def zero_counts() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def training(torch, np, card: str) -> dict:
    """r941_native training at full width, CTC and r941_5mC steps, the
    GPU step against the CPU step, and a checkpoint that basecalls;
    returns the 40-step run's launch counts."""
    from flappie_tpu_torch.basecall import preprocess_batch
    from flappie_tpu_torch.models.config import get_model_config
    from flappie_tpu_torch.models.params import init_synthetic, save_npz
    from flappie_tpu_torch.signal.fast5 import read_raw
    from flappie_tpu_torch.train import ctc, data, trainer

    dev = torch.device("cuda")
    cfg = get_model_config("r941_native")
    B, chunk, steps = TRAIN["batch"], TRAIN["chunk"], TRAIN["steps"]
    wdir = os.path.join(WORK, "train")
    reads_dir = os.path.join(wdir, "reads")
    rng = np.random.default_rng(5)
    names = write_reads(np, rng, reads_dir, TRAIN["reads"], (0, 0, 1))
    t0 = time.perf_counter()
    pre = preprocess_batch([read_raw(os.path.join(reads_dir, n)) for n, _ in names])
    segs = [rt.active() for rt in pre if rt is not None]
    teacher = trainer.to_device(init_synthetic(cfg, seed=0), dev)
    paths = data.viterbi_paths(cfg, teacher, segs, dev)
    X, Y = supervised_chunks(np, cfg, segs, paths, chunk)
    torch.cuda.synchronize()
    log(f"train corpus: {len(segs)} reads labelled by the teacher on the card, {X.shape[0]} "
        f"chunks of {X.shape[1]} samples ({Y.shape[1] - 1} blocks), "
        f"{time.perf_counter() - t0:.2f} s")

    def batch_of(sel, X=X, Y=Y):
        sig = torch.from_numpy(X[sel]).to(dev)
        return sig, torch.full((len(sel),), X.shape[1], dtype=torch.int32, device=dev), \
            torch.from_numpy(Y[sel]).to(dev)

    train_step, init = trainer.make_train_step(cfg, lr=TRAIN["lr"])
    params, opt = init(init_synthetic(cfg, seed=7), dev)
    order = rng.permutation(X.shape[0])
    losses, fwd, bwd, sels = [], [], [], []
    zero_counts()
    for step in range(steps):
        sel = order[(step * B) % X.shape[0] :][:B]
        if sel.size < B:
            order = rng.permutation(X.shape[0])
            sel = order[:B]
        sels.append(sel)
        batch = batch_of(sel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = trainer.nll_loss(params, cfg, *batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        fwd.append(t1 - t0)
        bwd.append(time.perf_counter() - t1)
        losses.append(loss.item())
    launches = check_counts(f"r941_native training, {steps} steps",
                            {"lstm_layer_train": 5 * steps, "crf_sum_scan": 2 * steps})
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    log(f"train r941_native: {steps} steps of batch {B}, loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(mean of first 3 {first:.4f}, last 3 {last:.4f}); launches {json.dumps(launches)}")
    log(f"train r941_native step time, median of {steps}: {1e3 * statistics.median(fwd):.1f} ms "
        f"forward + {1e3 * statistics.median(bwd):.1f} ms backward and update = "
        f"{1e3 * statistics.median([a + b for a, b in zip(fwd, bwd)]):.1f} ms [{card}]")
    log("train r941_native losses: " + json.dumps([round(v, 4) for v in losses]))
    if not np.isfinite(losses).all():
        raise AssertionError("r941_native training: a loss is not finite")
    if not last < 0.6 * first:
        raise AssertionError(f"r941_native training did not converge: {first} -> {last}")
    runs = {"r941_native_train": launches}
    runs.update(stream_training(torch, np, card, cfg, init, batch_of, sels, losses))
    # 3 more steps under torch.profiler: how much of a step the device is busy
    from torch.profiler import ProfilerActivity, profile

    batch = batch_of(order[:B])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            train_step(params, opt, *batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps += 3
    log_profile("r941_native training, 3 steps (profiler on)", prof, wall, card)

    # one step on the card against the same step on the port's CPU path
    leaves = trainer.tree_leaves(params)
    loss = trainer.nll_loss(params, cfg, *batch)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    cpu_params = {layer: {k: t.detach().cpu().requires_grad_() for k, t in d.items()}
                  for layer, d in params.items()}
    cpu_leaves = trainer.tree_leaves(cpu_params)
    t0 = time.perf_counter()
    cpu_loss = trainer.nll_loss(cpu_params, cfg, *(t.cpu() for t in batch))
    cpu_grads = torch.autograd.grad(cpu_loss, [t for _, t in cpu_leaves])
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    grad_err = max(rel_err(g.cpu(), w) for g, w in zip(grads, cpu_grads))
    log(f"train step gpu vs cpu: loss {loss.item():.6f} vs {cpu_loss.item():.6f} (relative "
        f"{loss_rel:.2e}), max over the {len(leaves)} gradients of max |delta| / max |grad| "
        f"{grad_err:.2e}; cpu step {cpu_s:.1f} s")
    if not (loss_rel <= 1e-5 and grad_err <= 1e-3):
        raise AssertionError(f"train step: GPU vs CPU outside the band ({loss_rel}, {grad_err})")

    # 3 steps under FLAPPIE_TPU_CONV_IMPL=pallas from fresh weights: K10
    # once a step, its first loss held to the default conv's on that batch
    p3, o3 = init(init_synthetic(cfg, seed=7), dev)
    default_loss = trainer.nll_loss(p3, cfg, *batch).item()
    zero_counts()
    with knobs({"FLAPPIE_TPU_CONV_IMPL": "pallas"}):
        conv_losses = [train_step(p3, o3, *batch).item() for _ in range(3)]
    got = check_counts("r941_native training under conv pallas, 3 steps",
                       {"conv12": 3, "lstm_layer_train": 15, "crf_sum_scan": 6})
    conv_rel = abs(conv_losses[0] - default_loss) / abs(default_loss)
    log(f"train r941_native under FLAPPIE_TPU_CONV_IMPL=pallas: losses {conv_losses}, the first "
        f"against the default conv's {default_loss:.6f} (relative {conv_rel:.2e}); launches "
        f"{json.dumps(got)}")
    if not (np.isfinite(conv_losses).all() and conv_rel <= 1e-5):
        raise AssertionError(f"training under conv pallas: losses {conv_losses}, relative "
                             f"{conv_rel} to the default conv's first")

    # CTC steps on r941_native, then nll steps on r941_5mC (K7 under autograd)
    exs = []
    for seg, path in zip(segs, paths):
        exs += data.chunk_examples(seg, path, cfg.total_stride, chunk, cfg.nbase)
    ctc_step, ctc_init = ctc.make_ctc_train_step(cfg, lr=TRAIN["lr"])
    p2, o2 = ctc_init(init_synthetic(cfg, seed=7), dev)
    zero_counts()
    ctc_losses = [ctc_step(p2, o2, *(torch.from_numpy(a).to(dev) for a in bt)).item()
                  for bt, _ in zip(data.batches(exs, chunk, B, cfg.nbase, drop_last=True),
                                   range(3))]
    got = check_counts("r941_native CTC, 3 steps", {"lstm_layer_train": 15, "crf_sum_scan": 6})
    log(f"train r941_native CTC: losses {ctc_losses}, launches {json.dumps(got)}")
    cfg5 = get_model_config("r941_5mC")
    paths5 = data.viterbi_paths(cfg5, trainer.to_device(init_synthetic(cfg5, seed=0), dev),
                                list(X[:B]), dev, batch=B)
    X5, Y5 = X[:B], np.stack(paths5).astype(np.int32)
    step5, init5 = trainer.make_train_step(cfg5, lr=TRAIN["lr"])
    p5, o5 = init5(init_synthetic(cfg5, seed=7), dev)
    zero_counts()
    losses5 = [step5(p5, o5, *batch_of(np.arange(B), X5, Y5)).item() for _ in range(3)]
    got = check_counts("r941_5mC training, 3 steps", {"grumod_layer": 15, "crf_sum_scan": 6})
    log(f"train r941_5mC: losses {losses5}, launches {json.dumps(got)}")
    if not np.isfinite(ctc_losses + losses5).all():
        raise AssertionError(f"a CTC or r941_5mC loss is not finite: {ctc_losses} {losses5}")

    # checkpoint: the train state round-trips bit for bit; the trained
    # student basecalls through the CLI
    state = os.path.join(wdir, "state.npz")
    trainer.save_train_state(state, params, opt, steps)
    q, qo = init(init_synthetic(cfg, seed=99), dev)
    _, _, step = trainer.load_train_state(state, q, qo)
    for (key, a), (_, b) in zip(leaves, trainer.tree_leaves(q)):
        sa, sb = opt.state[a], qo.state[b]
        if not (torch.equal(a, b) and all(torch.equal(sa[k], sb[k].to(sa[k].device))
                                          for k in ("step", "exp_avg", "exp_avg_sq"))):
            raise AssertionError(f"train state {key}: not restored bit for bit")
    if step != steps:
        raise AssertionError(f"train state: step {step}, saved {steps}")
    ckpt = os.path.join(wdir, "student.npz")
    save_npz(ckpt, {layer: {k: t.detach().cpu().numpy() for k, t in d.items()}
                    for layer, d in params.items()}, cfg)
    sub_dir = os.path.join(wdir, "subset")
    os.makedirs(sub_dir)
    subset = [n for n, _ in names[:4]]
    for n in subset:
        shutil.copy(os.path.join(reads_dir, n), sub_dir)
    out = os.path.join(wdir, "student.fastq")
    wall = run_cli(torch, [sub_dir, "-o", out, "--checkpoint", ckpt])
    with open(out) as fh:
        recs = parse_fastq(fh.read(), "ACGT")
    if sorted(recs) != sorted(subset):
        raise AssertionError(f"trained checkpoint: {len(recs)} FASTQ records for {len(subset)} reads")
    log(f"train checkpoint: {len(trainer.tree_leaves(q))} parameters and their Adam state "
        f"restored bit for bit; the trained student basecalled {len(recs)} reads through the "
        f"CLI --checkpoint in {wall:.2f} s")
    return runs


# the least max |delta| / max |grad| between the one-pass and the f32
# adjoints' gradients that shows FLAPPIE_TPU_GRAD_PRECISION=default changed
# the adjoint's products (f32 reorderings alone stay near 1e-7)
GRAD_MOVED = 1e-6


def grads_of(torch, loss, leaves):
    return torch.autograd.grad(loss, [t for _, t in leaves])


def stream_training(torch, np, card: str, cfg, init, batch_of, sels: list,
                    f32_losses: list) -> dict:
    """r941_native trained under the bf16 stream (make_train_step(...,
    stream=torch.bfloat16): K8-bf16 forward, the adjoint on f32 x and iW)
    from the student's init on the f32 run's batches, 40 steps: every loss
    finite, the last 3 below 0.6x the first 3, exact launch counts (5
    K8-bf16 and 5 bf16 affines and 2 K3/K4 a step; no f32 K8), the median
    step time beside the f32 run's; one step on 8 rows held against the port's CPU
    path (loss within 1e-3 relative, every gradient within 1e-2 of its max
    |value|: the bf16 outputs of kernel and plain version may lie one bf16
    ulp, 2^-8 = 3.9e-3 relative, apart, as the bf16 layers' band allows,
    and the loss averages such differences over 8 x 512 blocks); one step under
    FLAPPIE_TPU_GRAD_PRECISION=default (the one-pass adjoint): the same
    loss (within 1e-6 relative; bit-equality logged), every gradient
    within 5e-2 of the f32 adjoint's max |value|, and some gradient more
    than GRAD_MOVED of its max |value| from it (the env var reached the
    adjoint's products).  Then 3 steps of K8 at
    FLAPPIE_TPU_RNN_PRECISION=default on each stream, counted.  Returns
    the launch counts by run name."""
    from flappie_tpu_torch.models.params import init_synthetic
    from flappie_tpu_torch.train import trainer

    bf16 = torch.bfloat16
    steps = len(sels)
    step_fn, _ = trainer.make_train_step(cfg, lr=TRAIN["lr"], stream=bf16)
    params, opt = init(init_synthetic(cfg, seed=7), "cuda")
    losses, walls = [], []
    zero_counts()
    for sel in sels:
        batch = batch_of(sel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step_fn(params, opt, *batch).item())
        walls.append(time.perf_counter() - t0)
    runs = {"r941_native_train_bf16": check_counts(
        f"r941_native training under the bf16 stream, {steps} steps",
        {"lstm_layer_train_bf16": 5 * steps, "affine_bf16": 5 * steps,
         "crf_sum_scan": 2 * steps})}
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    log(f"train r941_native under the bf16 stream: {steps} steps on the f32 run's batches, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of first 3 {first:.4f}, last 3 {last:.4f}; "
        f"the f32 run {np.mean(f32_losses[:3]):.4f} -> {np.mean(f32_losses[-3:]):.4f}); step "
        f"median {1e3 * statistics.median(walls):.1f} ms; launches "
        f"{json.dumps(runs['r941_native_train_bf16'])} [{card}]")
    log("train r941_native bf16 stream losses: " + json.dumps([round(v, 4) for v in losses]))
    if not np.isfinite(losses).all() or not last < 0.6 * first:
        raise AssertionError(f"training under the bf16 stream: {first} -> {last}, {losses}")

    # 8 rows of the first batch: the CPU path's recurrences are 512 tiny
    # steps a layer, and the f32 check above already runs a whole batch
    batch = batch_of(sels[0][:8])
    leaves = trainer.tree_leaves(params)
    loss = trainer.nll_loss(params, cfg, *batch, stream=bf16)
    grads = grads_of(torch, loss, leaves)
    cpu_params = {layer: {k: t.detach().cpu().requires_grad_() for k, t in d.items()}
                  for layer, d in params.items()}
    t0 = time.perf_counter()
    cpu_loss = trainer.nll_loss(cpu_params, cfg, *(t.cpu() for t in batch), stream=bf16)
    cpu_grads = grads_of(torch, cpu_loss, trainer.tree_leaves(cpu_params))
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    grad_err = max(rel_err(g.cpu(), w) for g, w in zip(grads, cpu_grads))
    log(f"train step under the bf16 stream, gpu vs cpu: loss {loss.item():.6f} vs "
        f"{cpu_loss.item():.6f} (relative {loss_rel:.2e}), max over the {len(leaves)} gradients "
        f"of max |delta| / max |grad| {grad_err:.2e}; cpu step {cpu_s:.1f} s")
    if not (loss_rel <= 1e-3 and grad_err <= 1e-2):
        raise AssertionError(f"bf16 train step: GPU vs CPU outside the band ({loss_rel}, "
                             f"{grad_err})")
    os.environ["FLAPPIE_TPU_GRAD_PRECISION"] = "default"
    try:
        one_loss = trainer.nll_loss(params, cfg, *batch, stream=bf16)
        one = grads_of(torch, one_loss, leaves)
    finally:
        del os.environ["FLAPPIE_TPU_GRAD_PRECISION"]
    d_loss = abs(one_loss.item() - loss.item()) / abs(loss.item())
    g_err = max(rel_err(g, w) for g, w in zip(one, grads))
    log(f"train step under the bf16 stream at FLAPPIE_TPU_GRAD_PRECISION=default: loss "
        f"{one_loss.item():.6f} ({'bit-equal to' if one_loss.item() == loss.item() else 'beside'} "
        f"the f32 adjoint's run's {loss.item():.6f}, relative {d_loss:.2e}); the one-pass "
        f"adjoint's gradients against the f32 adjoint's: max over the {len(leaves)} of max "
        f"|delta| / max |grad| {g_err:.3e} (band 5e-2; above {GRAD_MOVED}: the level reached "
        f"the adjoint)")
    if not (d_loss <= 1e-6 and GRAD_MOVED < g_err <= 5e-2):
        raise AssertionError(f"grad default: loss {d_loss}, gradients {g_err}")

    # K8 at rnn default and at rnn high, 3 steps on each stream from the
    # student's init on the runs' first batches; at high the losses within
    # 1e-3 relative of the f32 step's on the same stream
    for level, run, stream, layer, affine in (
            ("default", "r941_native_train_default", torch.float32, "lstm_layer_train_p1",
             "affine_f32"),
            ("default", "r941_native_train_bf16_default", bf16, "lstm_layer_train_bf16_p1",
             "affine_bf16"),
            ("high", "r941_native_train_high", torch.float32, "lstm_layer_train_h3", "affine_f32"),
            ("high", "r941_native_train_bf16_high", bf16, "lstm_layer_train_bf16_h3",
             "affine_bf16")):
        step_at, _ = trainer.make_train_step(cfg, lr=TRAIN["lr"], stream=stream)
        p1, o1 = init(init_synthetic(cfg, seed=7), "cuda")
        zero_counts()
        with precision_levels(rnn=level):
            got = [step_at(p1, o1, *batch_of(sel)).item() for sel in sels[:3]]
        runs[run] = check_counts(f"{run}, 3 steps", {layer: 15, affine: 15,
                                                     "crf_sum_scan": 6})
        ref = (f32_losses if stream == torch.float32 else losses)[:3]
        rel = max(abs(g - w) / abs(w) for g, w in zip(got, ref))
        log(f"train r941_native at FLAPPIE_TPU_RNN_PRECISION={level}, stream {stream}: losses "
            f"{got} (the stream's first 3 at the f32 step: {[round(v, 6) for v in ref]}, "
            f"largest relative delta {rel:.2e}); launches {json.dumps(runs[run])}")
        if not np.isfinite(got).all() or (level == "high" and not rel <= 1e-3):
            raise AssertionError(f"{run}: losses {got}, the f32 step's {ref}")
    return runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    import flappie_tpu_torch
    from flappie_tpu_torch.ops import cuda_build

    pkg = os.path.dirname(os.path.abspath(flappie_tpu_torch.__file__))
    if pkg != os.path.join(HERE, "flappie_tpu_torch"):
        raise AssertionError(f"flappie_tpu_torch imported from {pkg}, not this checkout")

    # every phase runs the knobs' defaults unless a CLI run sets one
    os.environ.update(KNOBS)
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    peak = PEAKS["pcie" if "PCIe" in card else "sxm"]
    t0 = time.perf_counter()
    # the library step's CPU runs use no kernel: they run beside the builds
    refs = library_refs(np)
    variants = start_builds(cuda_build, VARIANTS)
    built = cuda_build.build()
    libs = finish_builds(variants)
    phase_seconds["build"] = time.perf_counter() - t0
    log(f"build: {built} and the variants {list(libs)} in {phase_seconds['build']:.2f} s")
    log("  nvcc seconds from the start to each exit, all at once: " + ", ".join(
        f"{n} {sec:.1f}" for n, sec in {**cuda_build.build_seconds, **variant_seconds}.items()))
    for name, text in cuda_build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"  {name}: {line.strip()}")
    for name in (n for n in libs if n.startswith("bt_")):
        log(f"  build {name}: " + "; ".join(
            f"{k} {ptxas_usage(variant_log[name], k)}"
            for k in ("crf_bt_fwd_kernel", "crf_bt_viterbi_kernel")))
    log_cluster_plans()
    log_scan_plans()
    log_bt_plans()
    log_tb_plans()
    log_affine_plans()
    rows = check_kernels(torch, peak, libs)
    shutil.rmtree(WORK, ignore_errors=True)
    launches = {}
    for model in RUNS:
        launches.update(timed("main_path", main_path, torch, np, card, model))
    timed("serve", serve_stdin_run, torch, np, card)
    timed("serve", serve_watch_run, torch, np, card)
    launches["rle_r941_native_pallas"] = timed("runnie_path", runnie_path, torch, np, card)
    launches.update(timed("fast_phase", fast_phase, torch, np, card))
    sloika_rows, sloika_launches = timed("sloika_phase", sloika_phase, torch, np, card, peak,
                                         libs)
    rows += sloika_rows
    launches.update(sloika_launches)
    launches.update(timed("multi_phase", multi_phase, torch, np, card, refs))
    timed("knobs_phase", knobs_phase, torch, np, card)
    timed("check_gradients", check_gradients, torch, card)
    launches.update(timed("training", training, torch, np, card))

    kernels = [{
        "name": r["name"], "route": r["route"], "source": r["source"],
        "replaces": r["replaces"], "launches": launches[r["run"]][r["counter"]],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    } for r in rows]
    log(f"phase seconds ({time.perf_counter() - t0:.1f} s since the build started): " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(phase_seconds.items(), key=lambda kv: -kv[1])))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
