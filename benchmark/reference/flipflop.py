"""Plain reference of the flip-flop basecallers (r941_native, r941_5mC):
raw ADC counts and weights in, one FASTQ record's fields out.

Written from the original flappie C code (nanoporetech/flappie: the conv
layer src/layers.c:189-276, LSTM :979-1026, GRU-mod :664-715, the
flip-flop head and its partition :1035-1106, the forward-backward
posterior src/decode.c:377-498, Viterbi :119-204, the record
src/flappie.c:254-300) as plain PyTorch, batch-major, one time step at a
time, with the chunking of long reads that the system under test uses
(chunks cut at the overlaps' midpoints, each decoded on its own, the
decoded paths stitched).  It imports nothing of the program and takes
nothing that the program made: the caller hands it the ADC counts, the
fast5 calibration and the weights that it also gave the program.

``precision``: ``"f32"`` is true float32 (TF32 off, set here and not
left to whoever imported torch before); ``"tf32"`` rounds
the operands of every matrix product and convolution to TF32 (10
mantissa bits, round to nearest even) and sums in float32, as the tensor
cores' TF32 mode does: the control, one precision below the
configuration's.

The harness finds this module by the configuration's ``reference`` key
and calls ``make_params``, ``checkpoint`` and ``records``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import signal

NEG_BIG = -3.0e38


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), as float32."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0x0FFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


@contextlib.contextmanager
def exact_float32():
    """cuBLAS and cuDNN's convolutions in true float32 (no TF32) inside,
    whatever the process had set; its settings restored on exit.  Set
    through the interface the process used: the legacy ``allow_tf32``
    flags, or where those cannot be read (the per-op ``fp32_precision``
    was set) that one."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    try:
        saved = [(m, "allow_tf32", m.allow_tf32), (c, "allow_tf32", c.allow_tf32)]
        off = False
    except RuntimeError:  # torch refuses to read the legacy flags
        saved = [(m, "fp32_precision", m.fp32_precision),
                 (c.conv, "fp32_precision", c.conv.fp32_precision)]
        off = "ieee"
    for obj, name, _ in saved:
        setattr(obj, name, off)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


class Model(NamedTuple):
    convs: list  # dicts: winlen, in_ch, out_ch, stride, activation
    rnns: list  # dicts: kind, size, backward
    nbase: int

    @property
    def stride(self) -> int:
        s = 1
        for c in self.convs:
            s *= c["stride"]
        return s

    @classmethod
    def from_config(cls, cfg: dict) -> "Model":
        w = cfg["widths"]
        if w["head"] != "flipflop":
            raise ValueError(f"the flip-flop reference runs flip-flop heads, not {w['head']!r}")
        return cls(list(w["convs"]), list(w["rnns"]), int(w["nbase"]))


class Network:
    """The forward graph at one precision."""

    def __init__(self, model: Model, params: Dict[str, torch.Tensor], precision: str = "f32"):
        if precision not in ("f32", "tf32"):
            raise ValueError(f"precision must be f32 or tf32, not {precision!r}")
        self.m = model
        self.p = params
        self.low = precision == "tf32"

    def _op(self, x):
        return _tf32(x) if self.low else x

    def _mm(self, x, w):
        return self._op(x) @ self._op(w)

    # -- convolution, with the C code's right edge ---------------------------

    def _conv(self, x, i: int, lengths: List[int]):
        """x [B, Cin, T] -> [B, Cout, ceil(T/stride)] (tail not masked)."""
        c = self.m.convs[i]
        W, b = self.p[f"conv{i}/W"], self.p[f"conv{i}/b"]  # [w, Cin, Cout], [Cout]
        w, s = c["winlen"], c["stride"]
        padL, padR = (w - 1) // 2, w // 2
        out = F.conv1d(F.pad(self._op(x), (padL, padR)), self._op(W).permute(2, 1, 0),
                       stride=s) + b[None, :, None]
        # the columns where the C loops apply other taps than the
        # mathematical same-convolution (src/layers.c:239-271)
        fixes = [(r, col, ents) for r, n in enumerate(lengths) if n >= w
                 for col, ents in _edge_columns(n, w, s).items()]
        if not fixes:
            return out
        Wo = self._op(W)
        xo = self._op(x)
        for r, col, ents in fixes:
            v = b.clone()
            for start, lo, hi in ents:
                for j in range(lo, hi):
                    pos = start + j
                    if 0 <= pos < lengths[r]:
                        v = v + xo[r, :, pos] @ Wo[j]
            out[r, :, col] = v
        return out

    # -- recurrent layers -------------------------------------------------------

    def _lstm(self, xa, sW):
        B, T, G = xa.shape
        H = G // 4
        h = xa.new_zeros(B, H)
        c = xa.new_zeros(B, H)
        ys = []
        for t in range(T):
            xF = xa[:, t] + self._mm(h, sW)
            u = torch.sigmoid(xF[:, :H])
            f = torch.sigmoid(xF[:, H:2 * H])
            g = torch.tanh(xF[:, 2 * H:3 * H])
            o = torch.sigmoid(xF[:, 3 * H:])
            c = f * c + u * g
            h = o * torch.tanh(c)
            ys.append(h)
        return torch.stack(ys, 1)

    def _grumod(self, xa, sW):
        B, T, G = xa.shape
        H = G // 3
        h = xa.new_zeros(B, H)
        ys = []
        for t in range(T):
            v = self._mm(h, sW)
            z = torch.sigmoid(xa[:, t, :H] + v[:, :H])
            r = torch.sigmoid(xa[:, t, H:2 * H] + v[:, H:2 * H])
            hbar = torch.tanh(r * v[:, 2 * H:] + xa[:, t, 2 * H:])
            h = z * h + (1 - z) * hbar
            ys.append(h)
        return torch.stack(ys, 1)

    def features(self, sig: torch.Tensor, lengths: List[int]):
        """sig [B, T] normalised signal (zero beyond each length) -> (the
        last recurrent layer's output [B, T', H], nblocks [B])."""
        dev = sig.device
        x = sig[:, None, :]
        lens = list(lengths)
        for i, c in enumerate(self.m.convs):
            y = self._conv(x, i, lens)
            act = c["activation"]
            y = y * torch.sigmoid(y) if act == "swish" else torch.tanh(y) if act == "tanh" else \
                torch.where(y >= 0, y, torch.expm1(y))
            lens = [-(-n // c["stride"]) for n in lens]
            keep = torch.arange(y.shape[-1], device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
            x = y * keep[:, None, :]
        x = x.transpose(1, 2)  # [B, T', C]
        nb = torch.tensor(lens, device=dev)
        T = x.shape[1]
        t = torch.arange(T, device=dev)[None, :]
        rev = torch.where(t < nb[:, None], nb[:, None] - 1 - t, t)  # per-read reversal
        keep = (t < nb[:, None])[..., None]
        for i, r in enumerate(self.m.rnns):
            xa = self._mm(x, self.p[f"rnn{i}/iW"]) + self.p[f"rnn{i}/b"]
            if r["backward"]:
                xa = torch.gather(xa, 1, rev[..., None].expand_as(xa))
            fn = self._lstm if r["kind"] == "lstm" else self._grumod
            y = fn(xa, self.p[f"rnn{i}/sW"])
            if r["backward"]:
                y = torch.gather(y, 1, rev[..., None].expand_as(y))
            x = y * keep
        return x, nb

    def head(self, x, nb, bias=None):
        """The flip-flop head on features x [B, T', H]: 5 tanh(x W + b),
        globally normalised over each read's valid blocks (``bias`` in
        place of the head's own, when given)."""
        keep = (torch.arange(x.shape[1], device=x.device)[None, :] < nb[:, None])[..., None]
        C = torch.tanh(self._mm(x, self.p["ff/W"]) + (self.p["ff/b"] if bias is None else bias)) * 5.0
        logZ = partition(C, nb, self.m.nbase)
        return (C - (logZ / nb.clamp(min=1))[:, None, None]) * keep

    def transitions(self, sig: torch.Tensor, lengths: List[int]):
        """sig [B, T] normalised signal (zero beyond each length) ->
        (trans [B, T', nparam] globally normalised, nblocks [B])."""
        x, nb = self.features(sig, lengths)
        return self.head(x, nb), nb


def _edge_columns(n: int, w: int, s: int) -> dict:
    """{column: [(window start, first tap, tap end), ...]} for the last
    columns of a conv over n samples whose taps the C loops choose
    differently from the mathematical same-convolution (a bias-only
    column has no entry).  Transcribed from src/layers.c:189-276: the
    body loop emits only windows inside whole blocks of stride *
    ceil(w / stride) samples, and the right-edge loop applies the leading
    w - 1 - wo taps at n - w + 1 + wo."""
    padL, padR = (w - 1) // 2, w // 2
    ncol = -(-n // s)
    ncolsL = -(-padL // s)
    shift = ncolsL * s - padL
    nstepC = -(-w // s)
    nstepX = s * nstepC
    maxcol = (n - shift) // nstepX
    rem = (n - shift) % nstepX
    colR0 = ncolsL + nstepC * (maxcol - 1) + rem // s + 1
    startR = s - (padL + n - w) % s - 1
    right: dict = {}
    for wo in range(startR, padR, s):
        right.setdefault(colR0 + wo // s, []).append((n - w + 1 + wo, 0, w - 1 - wo))
    out = {}
    for col in range(max(0, ncol - nstepC - 2), ncol):
        ents = []
        if col < ncolsL:
            ents.append((col * s - padL, padL - col * s, w))
        else:
            r, k = (col - ncolsL) % nstepC, (col - ncolsL) // nstepC
            if k < (n - shift - s * r) // nstepX:
                ents.append((shift + s * r + nstepX * k, 0, w))
        body = list(ents)
        ents += right.get(col, [])
        # a column the body covers and the right edge leaves alone is the
        # mathematical one
        if ents != body or not body:
            out[col] = ents
    return out


# -- the flip-flop CRF ---------------------------------------------------------

def _lse(a, b):
    return torch.logsumexp(torch.stack([a, b], -1), -1)


def forward_states(trans, nb, nbase: int):
    """alphas [B, T+1, S]: alpha_0 = 0; padded blocks keep alpha."""
    B, T, _ = trans.shape
    S = 2 * nbase
    off = nbase * S
    a = trans.new_zeros(B, S)
    out = [a]
    valid = torch.arange(T, device=trans.device)[None, :] < nb[:, None]
    for t in range(T):
        p = trans[:, t]
        flip = torch.logsumexp(p[:, :off].view(B, nbase, S) + a[:, None, :], -1)
        flop = _lse(a[:, nbase:] + p[:, off + nbase:], a[:, :nbase] + p[:, off:off + nbase])
        a = torch.where(valid[:, t, None], torch.cat([flip, flop], 1), a)
        out.append(a)
    return torch.stack(out, 1)


def backward_states(trans, nb, nbase: int):
    """betas [B, T+1, S]: zero at each read's last block and beyond."""
    B, T, _ = trans.shape
    S = 2 * nbase
    off = nbase * S
    beta = trans.new_zeros(B, S)
    out = [beta]
    valid = torch.arange(T, device=trans.device)[None, :] < nb[:, None]
    for t in range(T - 1, -1, -1):
        p = trans[:, t]
        into_flip = torch.logsumexp(p[:, :off].view(B, nbase, S) + beta[:, :nbase, None], 1)
        into_flop = p[:, off:] + beta[:, nbase:].repeat(1, 2)
        nxt = _lse(into_flip, into_flop)
        beta = torch.where(valid[:, t, None], nxt, beta)
        out.append(beta)
    return torch.stack(out[::-1], 1)


def partition(C, nb, nbase: int):
    """log partition function [B] over each read's valid blocks."""
    return torch.logsumexp(forward_states(C, nb, nbase)[:, -1], -1)


def _from_to(nbase: int):
    S = 2 * nbase
    off = nbase * S
    fr, to = [], []
    for t in range(nbase):
        for f in range(S):
            fr.append(f)
            to.append(t)
    for b in range(nbase):
        fr.append(b)
        to.append(nbase + b)
    for b in range(nbase):
        fr.append(nbase + b)
        to.append(nbase + b)
    param = np.full((S, S), -1, np.int64)
    for p, (f, t) in enumerate(zip(fr, to)):
        param[f, t] = p
    assert len(fr) == off + 2 * nbase
    return np.array(fr), np.array(to), param


def posterior(trans, nb, nbase: int):
    """Per-block normalised log transition posterior [B, T, nparam]."""
    fr, to, _ = _from_to(nbase)
    al = forward_states(trans, nb, nbase)
    be = backward_states(trans, nb, nbase)
    dev = trans.device
    tp = (al[:, :-1, torch.as_tensor(fr, device=dev)] + trans
          + be[:, 1:, torch.as_tensor(to, device=dev)])
    return tp - torch.logsumexp(tp, -1, keepdim=True)


def viterbi(M, nb, nbase: int):
    """Max-plus decode of M [B, T, nparam]: (path [B, T+1] int64 numpy,
    qpath [B, T+1] float32 numpy, qpath[:, 0] NaN).  Ties as the C loops
    break them: into a flip state the lowest origin, into a flop state
    the stay."""
    B, T, _ = M.shape
    S = 2 * nbase
    off = nbase * S
    dev = M.device
    prev = M.new_zeros(B, S)
    valid = torch.arange(T, device=dev)[None, :] < nb[:, None]
    ident = torch.arange(S, device=dev)[None, :].expand(B, S)
    stay_from = torch.arange(nbase, S, device=dev)
    bps = []
    for t in range(T):
        p = M[:, t]
        fv, fi = (prev[:, None, :] + p[:, :off].view(B, nbase, S)).max(-1)
        cand = torch.stack([prev[:, nbase:] + p[:, off + nbase:], prev[:, :nbase] + p[:, off:off + nbase]], -1)
        ov, oi = cand.max(-1)  # index 0 (the stay) wins ties
        oi = torch.where(oi == 0, stay_from[None, :], stay_from[None, :] - nbase)
        v = valid[:, t, None]
        prev = torch.where(v, torch.cat([fv, ov], 1), prev)
        bps.append(torch.where(v, torch.cat([fi, oi], 1), ident))
    last = prev.argmax(-1).cpu().numpy()
    bp = torch.stack(bps, 1).cpu().numpy()  # [B, T, S]
    path = np.empty((B, T + 1), np.int64)
    path[:, T] = last
    rows = np.arange(B)
    for t in range(T - 1, -1, -1):  # padded steps point to themselves
        path[:, t] = bp[rows, t, path[:, t + 1]]
    _, _, param = _from_to(nbase)
    Mn = M.cpu().numpy()
    sel = param[path[:, :-1], path[:, 1:]]
    q = np.take_along_axis(Mn, np.maximum(sel, 0)[..., None], 2)[..., 0]
    qpath = np.concatenate([np.full((B, 1), np.nan, np.float32), q.astype(np.float32)], 1)
    return path, qpath


class Record(NamedTuple):
    """What a FASTQ record says of one read."""

    uuid: str
    nsample: int
    trim_start: int
    trim_end: int
    nblock: int
    score: float
    normalised_score: float
    sequence: str
    quality: str


class Read(NamedTuple):
    uuid: str
    adc: np.ndarray  # int16
    offset: float
    range_: float
    digitisation: float


def basecall_reads(reads: Sequence[Read], model: Model, params: Dict[str, torch.Tensor],
                   decode: dict, precision: str = "f32", device="cpu",
                   batch_chunks: int = 256) -> List[Record]:
    """One Record per read (None where trimming consumed it): trim and
    normalise each read, cut it into chunks (one chunk where it fits),
    run the network and the fb-then-Viterbi decode on each chunk, stitch
    the chunks' paths, Phred bytes and owned scores."""
    net = Network(model, {k: v.to(device) for k, v in params.items()}, precision)
    stride = model.stride
    chunk, overlap = int(decode["chunk_samples"]), int(decode["overlap"])
    jobs = []  # (read index, Chunk, normalised segment)
    state = {}
    for i, rd in enumerate(reads):
        raw = signal.scale_to_pA(rd.adc, rd.offset, rd.range_, rd.digitisation)
        win = signal.trim(raw, *decode["trim"], *decode["segmentation"])
        if win is None:
            state[i] = None
            continue
        seg = signal.normalise(raw[win[0]:win[1]])
        nblk, chunks = signal.plan_chunks(seg.size, stride, chunk, overlap)
        state[i] = dict(win=win, n=raw.size, nb=nblk, score=0.0,
                        path=np.zeros(nblk + 1, np.int64), qchar=np.zeros(nblk + 1, np.uint8))
        jobs += [(i, c, seg) for c in chunks]
    width = chunk - chunk % stride
    with torch.no_grad(), exact_float32():
        for k in range(0, len(jobs), batch_chunks):
            part = jobs[k:k + batch_chunks]
            sig = np.zeros((len(part), width), np.float32)
            for j, (_, c, seg) in enumerate(part):
                sig[j, :c.length] = seg[c.start:c.start + c.length]
            trans, nb = net.transitions(torch.from_numpy(sig).to(device), [c.length for _, c, _ in part])
            M = posterior(trans, nb, model.nbase) if decode["fb"] else trans
            path, qpath = viterbi(M, nb, model.nbase)
            qch = signal.phred_chars(np.nan_to_num(qpath, nan=0.0))
            for j, (i, c, _) in enumerate(part):
                st = state[i]
                end = c.keep_hi + (1 if c.last else 0)
                st["path"][c.keep_lo:end] = path[j, c.keep_lo - c.g0:end - c.g0]
                st["qchar"][c.keep_lo:end] = qch[j, c.keep_lo - c.g0:end - c.g0]
                st["score"] += float(qpath[j, c.qlo:c.qhi].sum(dtype=np.float32))
    out = []
    for i, rd in enumerate(reads):
        st = state[i]
        if st is None:
            out.append(None)
            continue
        seq, qual = signal.basecall(st["path"], st["qchar"], st["nb"], model.nbase)
        score = float(st["score"])
        norm = float(np.float32(-st["score"]) / np.float32(st["nb"]))
        out.append(Record(rd.uuid, st["n"], st["win"][0], st["win"][1], st["nb"], score, norm,
                          seq, qual))
    return out


def make_params(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights from the seed, on ``device``,
    calibrated (``flipflop_weights``)."""
    from . import flipflop_weights

    params = flipflop_weights.make(config["widths"], seed, device)
    flipflop_weights.calibrate(params, config, seed, device)
    return params


def checkpoint(params: Dict[str, torch.Tensor], path: str) -> str:
    """The weights as the program's ``--checkpoint`` file."""
    from . import flipflop_weights

    return flipflop_weights.save_npz(params, path)


def records(config: dict, reads, channel: dict, params: Dict[str, torch.Tensor], device,
            precision: str = "f32") -> Dict[str, dict]:
    """uuid -> the record's fields (as ``check.parse_fastq`` gives them,
    the normalised score as the record prints it) of each ``(uuid, adc)``
    in ``reads``, from the fast5 ``channel`` calibration."""
    rs = [Read(u, adc, channel["offset"], channel["range"], channel["digitisation"])
          for u, adc in reads]
    got = basecall_reads(rs, Model.from_config(config), params, config["decode"],
                         precision=precision, device=device)
    return {r.uuid: dict(nsample=r.nsample, trim=(r.trim_start, r.trim_end), nblock=r.nblock,
                         score=float(f"{r.normalised_score:f}"), sequence=r.sequence,
                         quality=r.quality) for r in got if r is not None}
