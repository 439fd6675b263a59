#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (flappie_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Card and build: the card's name and power limit, the torch/CUDA
   versions, then every CUDA kernel built from flappie_tpu_torch/csrc/
   with nvcc for sm_90a (one nvcc per source, all at once) and the build
   seconds.
2. Kernels: each kernel held against its plain PyTorch version on the
   card at production shapes -- K1 fused LSTM layer, K8 its training
   variant (h and c; h bit-equal to K1's) and K7 fused GRU-mod layer
   (T=2560, B=256, IN=H=256, both directions, ragged lengths including 0
   and T, K7 with a candidate bias far from zero) within max |delta|
   1e-4; K3/K4 CRF sum scan within rtol 1e-5; K5 Viterbi and K6
   traceback bit-equal (T=2560, B=256, ragged nblocks), at S=8 (4 bases)
   and at S=10 (5 bases).  Times are CUDA-event medians after a warm-up;
   the bound is the larger of bytes over the card's memory rate and f32
   operations over its non-tensor f32 rate, counted for this run's
   inputs; the library time is one cuDNN nn.LSTM / nn.GRU call on the
   packed ragged batch (for K8 its training-mode forward).
3. Main paths, full width, synthetic weights, through
   flappie_tpu_torch.cli.flappie.main, default flags and then --viterbi:
   r941_native on 64 seeded synthetic fast5 reads of ~100k samples
   (three 256-chunk batches of 12800 samples) and 16 of <= 12.8k samples
   (the bucket path); r941_5mC on 24 reads of 40k-60k samples (two
   256-chunk batches of 5120 samples) and 8 of 2k-5k samples.  Every
   launch counter is zeroed just before each run and read just after
   and must equal the count the reads imply; one FASTQ record per read;
   4 reads of each model held against the port's own CPU path (identity
   >= 99.5%, |score delta| <= 1e-4); the device time of one full chunk
   batch; one more fb run under torch.profiler.
4. Training: the autograd Functions of the training path against
   autograd through the plain versions (T=512, B=32, H=256; every
   gradient within 1e-3 of its max |value|) and one layer's adjoint
   backward timed beside cuDNN's; r941_native trained at full width for
   40 steps (batch 32, 2560-sample chunks of 96 synthetic reads labelled
   on the card by a teacher's Viterbi paths, Adam at lr 2e-4): every loss
   finite, the last 3 below 0.6x the first 3, exact launch counts (5 K8
   and 2 K3/K4 a step, no K1), the median step split into forward and
   backward, one step against the port's CPU path (loss within 1e-5
   relative, gradients within 1e-3); 3 CTC steps on r941_native and 3
   steps on r941_5mC (K7 under autograd) with exact counts; the train
   state saved and restored bit for bit, and the trained student
   basecalling 4 reads through the CLI's --checkpoint.
5. The card line, one JSON line with every kernel's numbers, and the
   last line {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.  Writes only under
build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import json
import os
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
    "sxm": {"f32_ops": 67e12, "bytes": 3.35e12},
    "pcie": {"f32_ops": 51e12, "bytes": 2.0e12},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound(bytes_: float, ops: float, peak: dict):
    t_bytes = bytes_ / peak["bytes"] * 1e3
    t_ops = ops / peak["f32_ops"] * 1e3
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
    ms = cuda_ms(torch, lambda: fn(x, iW, b, sW, True, lengths), 3)
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
        library_ms = cuda_ms(torch, lambda: ref(packed), 3)
    got = fn(x, iW, b, sW, False, lengths)
    got = got[0] if train else got
    lib_err = ((lib_out.detach() - got) * mask).abs().max().item()
    log(f"{kid} library call computes the same function: max |cuDNN - kernel| {lib_err:.2e} "
        "over the valid steps (forward)")
    nvalid = int(lengths.sum().item())
    layer_bytes = 4 * (nvalid * IN + IN * G + G + H * G + B + T * B * H * (2 if train else 1))
    layer_ops = 2 * nvalid * (IN + H) * G
    bms, by = bound(layer_bytes, layer_ops, peak)
    return row(counter, kid, source, replaces, run, counter, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)


def check_scans(torch, peak: dict, gen, nbase: int) -> list:
    """K3/K4, K5, K6 on one dense batch, T=2560, B=256, S=2*nbase."""
    from flappie_tpu_torch.ops import crf_bm_cuda
    from flappie_tpu_torch.ops.crf import flipflop_index
    from flappie_tpu_torch.ops.crf_bm import _dense_tm

    dev = torch.device("cuda")
    T, B = 2560, 256
    S = 2 * nbase
    run, sfx = ("r941_native", "") if nbase == 4 else ("r941_5mC", f"_s{S}")
    rows = []
    idx = flipflop_index(nbase)
    trans = torch.randn(T, idx.nparam, B, generator=gen, device=dev) * 2.0
    nblocks = torch.randint(1, T, (B,), generator=gen, device=dev)
    nblocks[0], nblocks[1] = T, 0
    tvalid = torch.arange(T, device=dev)[:, None] < nblocks[None, :]
    dense = _dense_tm(trans, idx)
    nv = int(tvalid.sum().item())
    dense_bytes = 4 * T * S * S * B

    err = 0.0
    for backward in (False, True):
        got = crf_bm_cuda.sum_states(dense, tvalid, backward)
        want = crf_bm_cuda.sum_states_plain(dense, tvalid, backward)
        torch.cuda.synchronize()
        delta = (got - want).abs()
        if not bool((delta <= 1e-5 * want.abs() + 1e-5).all()):
            raise AssertionError(f"K3/K4 crf_sum_scan S={S} (backward={backward}): "
                                 "outside rtol 1e-5")
        err = max(err, delta.max().item())
    ms = cuda_ms(torch, lambda: crf_bm_cuda.sum_states(dense, tvalid, False), 5)
    plain_ms = cuda_ms(torch, lambda: crf_bm_cuda.sum_states_plain(dense, tvalid, False), 1)
    bms, by = bound(dense_bytes + 4 * T * B + 4 * (T + 1) * S * B, nv * (5 * S * S + 5 * S), peak)
    rows.append(row("crf_sum_scan" + sfx, "K3/K4", "crf_scan.cu", "crf_bm_pallas.py:69", run,
                    "crf_sum_scan", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=None))

    alpha, bps = crf_bm_cuda.viterbi_fwd(dense, tvalid, idx.tie_rank)
    alpha0, bps0 = crf_bm_cuda.viterbi_fwd_plain(dense, tvalid, idx.tie_rank)
    if not (torch.equal(alpha, alpha0) and torch.equal(bps, bps0)):
        raise AssertionError(f"K5 crf_viterbi S={S}: not bit-equal to its plain version")
    ms = cuda_ms(torch, lambda: crf_bm_cuda.viterbi_fwd(dense, tvalid, idx.tie_rank), 5)
    plain_ms = cuda_ms(torch, lambda: crf_bm_cuda.viterbi_fwd_plain(dense, tvalid, idx.tie_rank), 1)
    bms, by = bound(dense_bytes + 4 * T * B + 4 * S * S + 4 * T * S * B + 4 * S * B,
                    nv * (4 * S * S + 3 * S), peak)
    rows.append(row("crf_viterbi" + sfx, "K5", "crf_scan.cu", "crf_bm_pallas.py:135", run,
                    "crf_viterbi", max_abs_err=(alpha - alpha0).abs().max().item(), ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None))

    last = alpha.argmax(dim=0).to(torch.int32)
    path = crf_bm_cuda.traceback(bps, tvalid, last)
    path0 = crf_bm_cuda.traceback_plain(bps, tvalid, last)
    if not torch.equal(path, path0):
        raise AssertionError(f"K6 crf_traceback S={S}: not equal to its plain version")
    ms = cuda_ms(torch, lambda: crf_bm_cuda.traceback(bps, tvalid, last), 5)
    plain_ms = cuda_ms(torch, lambda: crf_bm_cuda.traceback_plain(bps, tvalid, last), 1)
    bms, by = bound(4 * T * S * B + 4 * T * B + 4 * B + 4 * (T + 1) * B, nv * S, peak)
    rows.append(row("crf_traceback" + sfx, "K6", "crf_scan.cu", "crf_bm_pallas.py:170", run,
                    "crf_traceback", max_abs_err=float((path - path0).abs().max().item()),
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None))
    return rows


def check_kernels(torch, peak: dict) -> list:
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = [check_layer(torch, peak, gen, kind) for kind in LAYER_KERNELS]
    rows += check_scans(torch, peak, gen, nbase=4) + check_scans(torch, peak, gen, nbase=5)
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
    from flappie_tpu_torch.basecall import bucket_length, preprocess_batch
    from flappie_tpu_torch.parallel.chunking import plan_chunks
    from flappie_tpu_torch.signal.fast5 import read_raw

    stride = cfg.total_stride
    chunk = 2560 * stride
    t0 = time.perf_counter()
    pre = preprocess_batch([read_raw(os.path.join(reads_dir, n)) for n, _ in names])
    log(f"host: fast5 read + preprocessing of {len(names)} reads on one thread: "
        f"{time.perf_counter() - t0:.3f} s")
    nchunk, buckets = 0, {}
    for rt in pre:
        L = rt.end - rt.start
        if L > chunk:
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
        recs[meta["filename"]] = (seq, meta["normalised_score"])
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
    (the int16 wire, fb decode, 2560 blocks a chunk), outside the CLI."""
    from flappie_tpu_torch.basecall import (
        _device_basecall_chunk_packed_i16, pack_chunk_inputs_i16)
    from flappie_tpu_torch.models.params import init_synthetic, params_to_torch
    from flappie_tpu_torch.signal.synthetic import synthetic_adc

    params = params_to_torch(init_synthetic(cfg, seed=0), "cuda")
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
        ms = cuda_ms(torch, lambda: _device_basecall_chunk_packed_i16(
            params, buf, cfg, 1.0, False, False), 2)
    log(f"device {cfg.name}: chunk program, one batch of {CB} x {W} samples: {ms:.1f} ms = "
        f"{CB * W / ms / 1e3:.3f} Msamples/s device-only [{card}]")


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


def log_profile(what: str, prof, wall: float, card: str) -> None:
    got = device_time(prof)
    if got is None:
        log(f"profile {what}: no device events recorded; device busy share not measured")
        return
    busy, span, by_name = got
    log(f"profile {what}: wall {wall:.3f} s, device busy {busy / 1e6:.3f} s = "
        f"{100 * busy / 1e6 / wall:.1f}% of the wall, span of device work {span / 1e6:.3f} s "
        f"[{card}]")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  kernel time {us / 1e3:9.1f} ms  {name[:90]}")


def profiled_run(torch, reads_dir: str, card: str, model: str) -> None:
    """The default run once more under torch.profiler (device activity
    only): the device busy share of the wall, and kernel time by name."""
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(os.path.dirname(reads_dir), "gpu_fb_profiled.fastq")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = run_cli(torch, [reads_dir, "-o", out, "--model", model])
    log_profile(f"{model} (fb run, profiler on)", prof, wall, card)


def run_cli(torch, args: list) -> float:
    from flappie_tpu_torch.cli.flappie import main

    t0 = time.perf_counter()
    rc = main(args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"flappie CLI exited {rc} for {args}")
    return wall


def launch_counters() -> dict:
    """Every kernel wrapper's launch counter, by counter name."""
    from flappie_tpu_torch.ops import crf_bm_cuda, rnn_cuda

    return {
        "lstm_layer": rnn_cuda.lstm_layer_tm,
        "lstm_layer_train": rnn_cuda.lstm_layer_tm_train,
        "grumod_layer": rnn_cuda.grumod_layer_tm,
        "crf_sum_scan": crf_bm_cuda.sum_states,
        "crf_viterbi": crf_bm_cuda.viterbi_fwd,
        "crf_traceback": crf_bm_cuda.traceback,
    }


def main_path(torch, np, card: str, model: str) -> dict:
    """One model's main path in fb and --viterbi; returns the fb run's
    launch counts."""
    from flappie_tpu_torch.models.config import get_model_config

    cfg = get_model_config(model)
    counters = launch_counters()
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
    for mode, extra in (("fb", []), ("viterbi", ["--viterbi"])):
        out = os.path.join(wdir, f"gpu_{mode}.fastq")
        for fn in counters.values():
            fn.launches = 0
        wall = run_cli(torch, [reads_dir, "-o", out, "--model", model] + extra)
        got = {k: fn.launches for k, fn in counters.items()}
        want = dict.fromkeys(counters, 0)
        want.update({layer: len(cfg.rnns) * P, "crf_sum_scan": (3 if mode == "fb" else 1) * P,
                     "crf_viterbi": P, "crf_traceback": P})
        if got != want:
            raise AssertionError(f"{model} {mode}: kernel launches {got}, expected {want}")
        with open(out) as fh:
            recs = parse_fastq(fh.read(), alphabet)
        if sorted(recs) != sorted(n for n, _ in names):
            raise AssertionError(f"{model} {mode}: {len(recs)} FASTQ records for "
                                 f"{len(names)} reads")
        outputs[mode] = recs
        if mode == "fb":
            launches = got
        log(f"main path {model} {mode}: {len(recs)} reads, wall {wall:.3f} s, "
            f"{nsample / wall / 1e6:.3f} Msamples/s, launches {json.dumps(got)} [{card}]")

    # a subset against the port's own CPU path
    subset = [names[0][0], names[1][0], names[-2][0], names[-1][0]]
    sub_dir = os.path.join(wdir, "subset")
    os.makedirs(sub_dir)
    for n in subset:
        shutil.copy(os.path.join(reads_dir, n), sub_dir)
    cpu_out = os.path.join(wdir, "cpu_fb.fastq")
    cpu_wall = run_cli(torch, [sub_dir, "-o", cpu_out, "--model", model, "--device", "cpu"])
    with open(cpu_out) as fh:
        cpu = parse_fastq(fh.read(), alphabet)
    worst_id, worst_ds = 1.0, 0.0
    for n in subset:
        ident = identity(outputs["fb"][n][0], cpu[n][0])
        ds = abs(outputs["fb"][n][1] - cpu[n][1])
        worst_id, worst_ds = min(worst_id, ident), max(worst_ds, ds)
        log(f"gpu vs cpu {model} {n}: identity {ident:.6f}, |score delta| {ds:.2e}")
        if not (ident >= 0.995 and ds <= 1e-4):
            raise AssertionError(f"{model} {n}: GPU vs CPU outside the band (identity "
                                 f"{ident}, score delta {ds})")
    log(f"gpu vs cpu {model}: {len(subset)} reads, min identity {worst_id:.6f}, "
        f"max |score delta| {worst_ds:.2e}, cpu wall {cpu_wall:.1f} s")
    time_chunk_program(torch, np, rng, card, cfg)
    profiled_run(torch, reads_dir, card, model)
    return launches


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


def check_counts(what: str, want: dict) -> dict:
    got = {k: fn.launches for k, fn in launch_counters().items()}
    full = dict.fromkeys(got, 0)
    full.update(want)
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
    losses, fwd, bwd = [], [], []
    zero_counts()
    for step in range(steps):
        sel = order[(step * B) % X.shape[0] :][:B]
        if sel.size < B:
            order = rng.permutation(X.shape[0])
            sel = order[:B]
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
    return launches


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

    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    peak = PEAKS["pcie" if "PCIe" in card else "sxm"]
    t0 = time.perf_counter()
    built = cuda_build.build()
    log(f"build: {built} in {time.perf_counter() - t0:.2f} s")
    for name, text in cuda_build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    rows = check_kernels(torch, peak)
    shutil.rmtree(WORK, ignore_errors=True)
    launches = {model: main_path(torch, np, card, model) for model in RUNS}
    check_gradients(torch, card)
    launches["r941_native_train"] = training(torch, np, card)

    kernels = [{
        "name": r["name"], "route": r["route"], "source": r["source"],
        "replaces": r["replaces"], "launches": launches[r["run"]][r["counter"]],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    } for r in rows]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
