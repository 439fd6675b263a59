"""What decides ``correct``: the records the timed path wrote, held to
the plain reference's records of the same reads.

Numbers compared, over the sampled reads:

- ``meta_mismatch``: reads whose record is missing on one side, or
  whose read id, sample count, trim or block count differ (exact);
- ``seq_err``: the edit distances between the program's and the
  reference's sequences, summed, over the reference's bases;
- ``rec_err``: the same over (base, quality character) pairs, so a
  base whose Phred character moved counts;
- ``score_gap_max``: the widest gap between a read's printed normalised
  scores.

Each limit sits in ``limits/<workload>.json`` with the readings it was
set from.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

HEADER = re.compile(
    r'^@(?P<name>\S+)  \{ "filename" : "(?P<filename>[^"]*)", "uuid" : "(?P<uuid>[^"]*)", '
    r'"normalised_score" : (?P<score>\S+),  "nblock" : (?P<nblock>\d+),  '
    r'"sequence_length" : (?P<seqlen>\d+),  "blocks_per_base" : (?P<bpb>\S+), '
    r'"nsample" : (?P<nsample>\d+), "trim" : \[ (?P<t0>\d+), (?P<t1>\d+) \] \}$')

NUMBERS = ("meta_mismatch", "seq_err", "rec_err", "score_gap_max")
# anchors of the segment-wise edit distance: unique k-mers tried every
# ANCHOR_EVERY bases
ANCHOR_K, ANCHOR_EVERY = 24, 256


def parse_fastq(text: str) -> Dict[str, dict]:
    """uuid -> {nsample, trim, nblock, score, sequence, quality} of each
    FASTQ record (the program's header layout)."""
    out = {}
    lines = text.split("\n")
    for k in range(0, len(lines) - 3, 4):
        m = HEADER.match(lines[k])
        if m is None:
            raise ValueError(f"not a record header: {lines[k][:120]!r}")
        out[m["uuid"]] = dict(nsample=int(m["nsample"]), trim=(int(m["t0"]), int(m["t1"])),
                              nblock=int(m["nblock"]), score=float(m["score"]),
                              sequence=lines[k + 1], quality=lines[k + 3])
    return out


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance of two symbol sequences (Myers' bit-vector
    algorithm in Hyyrö's global form, on Python integers)."""
    m = len(a)
    if m == 0:
        return len(b)
    if len(b) == 0:
        return m
    peq: dict = {}
    for i, c in enumerate(a):
        peq[c] = peq.get(c, 0) | (1 << i)
    mask = (1 << m) - 1
    hb = 1 << (m - 1)
    pv, mv, score = mask, 0, m
    for c in b:
        eq = peq.get(c, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | (~(xh | pv) & mask)
        mh = pv & xh
        if ph & hb:
            score += 1
        elif mh & hb:
            score -= 1
        ph = ((ph << 1) | 1) & mask
        mh = (mh << 1) & mask
        pv = mh | (~(xv | ph) & mask)
        mv = ph & xv
    return score


def _pairs(seq: str, qual: str) -> List[int]:
    return [ord(s) << 8 | ord(q) for s, q in zip(seq, qual)]


def _anchors(a: str, b: str, k: int = ANCHOR_K, every: int = ANCHOR_EVERY) -> List[tuple]:
    """(i, j) pairs, increasing in both, where the k-mer a[i:i+k] occurs
    once in ``a`` and once in ``b``, at j: points that an optimal
    alignment of two near-equal sequences passes through."""
    def counts(s):
        pos: dict = {}
        for x in range(len(s) - k + 1):
            km = s[x:x + k]
            pos[km] = -1 if km in pos else x
        return pos

    ca, cb = counts(a), counts(b)
    out, last = [], -1
    for i in range(0, len(a) - k + 1, every):
        km = a[i:i + k]
        j = cb.get(km, -1)
        if ca.get(km) == i and j > last:
            out.append((i, j))
            last = j
    return out


def distances(a: str, qa: str, b: str, qb: str) -> tuple:
    """(edit distance of the sequences, of their (base, quality) pairs),
    each summed over the segments between shared unique k-mers (the
    whole pair where there is none)."""
    cuts = [(0, 0)] + _anchors(a, b) + [(len(a), len(b))]
    pa, pb = _pairs(a, qa), _pairs(b, qb)
    ds = dq = 0
    for (i0, j0), (i1, j1) in zip(cuts[:-1], cuts[1:]):
        ds += edit_distance(a[i0:i1], b[j0:j1])
        dq += edit_distance(pa[i0:i1], pb[j0:j1])
    return ds, dq


def compare(got: Dict[str, dict], want: Dict[str, dict],
            per_read: Optional[list] = None) -> Dict[str, float]:
    """The numbers of NUMBERS over the reference's records ``want`` against
    the program's ``got``, both by read id in ``parse_fastq``'s shape (a
    read the reference trimmed away is not in ``want``); each read's
    (bases, sequence edits, pair edits, score gap) appended to
    ``per_read`` when it is given."""
    meta, bases, ds_all, dq_all, gap = 0, 0, 0, 0, 0.0
    for uuid, rec in want.items():
        g = got.get(uuid)
        if g is None or any(g[k] != rec[k] for k in ("nsample", "trim", "nblock")):
            meta += 1
            continue
        ds, dq = distances(rec["sequence"], rec["quality"], g["sequence"], g["quality"])
        g_gap = abs(g["score"] - rec["score"])
        bases += len(rec["sequence"])
        ds_all += ds
        dq_all += dq
        gap = max(gap, g_gap)
        if per_read is not None:
            per_read.append((len(rec["sequence"]), ds, dq, g_gap))
    n = max(1, bases)
    return {"meta_mismatch": meta, "seq_err": ds_all / n, "rec_err": dq_all / n,
            "score_gap_max": gap}


def verdict(numbers: Dict[str, float], limits: dict) -> bool:
    return all(numbers[k] <= limits[k]["limit"] for k in NUMBERS)
