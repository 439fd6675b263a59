"""The one-pass layers' early-steps band against the rows it is held over,
on one CUDA card.

    python3 p1_band.py [DRAWS]

The P1 band (chip_smoke.py: P1_MAX, P1_MEAN, and P1_EARLY, a mean over the
first P1_STEPS steps each row walks) was read at T=2560, B=256.  A sound
one-pass kernel agrees with its plain twin to f32 rounding until one h's
two sums straddle a bf16 rounding boundary; from that step on the row's
walk leaves the twin's.  This script shows how that reads at the small
batches of the every-R checks.  For K1-default and K7-default
(ops/rnn_cuda.py ``lstm_layer_tm_p1``, ``grumod_layer_tm_p1``) at B = 1,
3 and 24, T=40, IN=H=256, chip_smoke.py's ``layer_inputs``, on the f32
and bf16 streams, both directions:

1. DRAWS (default 40) independent draws of B rows, each alone: how many
   of the 4 DRAWS early means exceed P1_EARLY, their worst and median,
   and the f32-step control's smallest;
2. DRAWS / 4 trials of a batch of at least chip_smoke.P1_POOL_ROWS rows
   launched B rows at a time (``p1_rows_outputs``), as check_p1_rows and
   the card tests hold them: the same counts over 4 x DRAWS / 4 bands;
3. one draw of K7-default at B=1, step by step backward from its length:
   the mean and max |delta| of each of its first 20 steps against the
   twin, and the control's mean.

Prints the card's name and power limit last.  Imports nothing of JAX or of
the JAX package.  Exits 1 when no CUDA card is visible.
"""

from __future__ import annotations

import statistics
import sys

import chip_smoke as cs

T, IN, H = 40, 256, 256
CELLS = {"lstm": (4, "K1-default"), "grumod": (3, "K7-default")}


def draw(torch, gen, gates: int, rows: int, B: int):
    """(x, iW, b, sW, lengths) of ``rows`` rows (row 0 of length T, row 1,
    if any, of 0), to be launched B rows at a time."""
    x, iW, b, sW, lengths = cs.layer_inputs(torch, gen, gates, T, max(rows, 2), IN, H)
    return x[:, :rows].contiguous(), iW, b, sW, lengths[:rows].contiguous()


def early_means(torch, cell: str, inputs, B: int) -> list:
    """[(the one-pass h's early mean, the control's)] against the twin on
    each stream and direction."""
    from flappie_tpu_torch.ops import rnn_cuda

    x, iW, b, sW, lengths = inputs
    got = []
    for xs in (x, x.to(torch.bfloat16)):
        for backward in (False, True):
            pairs, ctl, _ = cs.p1_rows_outputs(torch, rnn_cuda, cell,
                                               (xs, iW, b, sW, backward, lengths), B)
            early = cs.first_steps(torch, T, lengths, backward, cs.P1_STEPS)
            h, want = pairs[0]
            got.append((cs.p1_distance(h, want, early)[2], cs.p1_distance(ctl, want, early)[2]))
    return got


def summary(what: str, means: list) -> str:
    sound = [m[0] for m in means]
    over = sum(v > cs.P1_EARLY for v in sound)
    return (f"{what}: {over} of {len(sound)} above P1_EARLY {cs.P1_EARLY:.1e}, worst "
            f"{max(sound):.2e}, median {statistics.median(sound):.2e}; control smallest "
            f"{min(m[1] for m in means):.2e}")


def bands(torch, cell: str, B: int, draws: int, card: str) -> None:
    gates, kid = CELLS[cell]
    gen = torch.Generator(device="cuda").manual_seed(7000 + 10 * B + gates)
    rows = -(-cs.P1_POOL_ROWS // B) * B
    alone = [m for _ in range(draws)
             for m in early_means(torch, cell, draw(torch, gen, gates, B, B), B)]
    pooled = [m for _ in range(draws // 4)
              for m in early_means(torch, cell, draw(torch, gen, gates, rows, B), B)]
    cs.log(f"{kid} at B={B}, T={T} [{card}]: " + summary(f"{draws} draws alone", alone) + "; "
           + summary(f"{draws // 4} batches of {rows} rows, {rows // B} launches each", pooled))


def walk(torch, card: str) -> None:
    """K7-default at B=1, f32 stream, backward, step by step: the first
    draw (of 20) whose early mean exceeds P1_EARLY, else the last."""
    from flappie_tpu_torch.ops import rnn_cuda

    gen = torch.Generator(device="cuda").manual_seed(7100)
    for _ in range(20):
        x, iW, b, sW, lengths = draw(torch, gen, 3, 1, 1)
        pairs, ctl, _ = cs.p1_rows_outputs(torch, rnn_cuda, "grumod",
                                           (x, iW, b, sW, True, lengths), 1)
        (got, want), = pairs
        mean = cs.p1_distance(got, want, cs.first_steps(torch, T, lengths, True, cs.P1_STEPS))[2]
        if mean > cs.P1_EARLY:
            break
    d = (got - want).abs()[:, 0, :]
    c = (ctl - want).abs()[:, 0, :]
    steps = range(T - 1, T - 21, -1)
    cs.log(f"K7-default at B=1, f32 stream, backward, early mean {mean:.2e}, step by step from "
           f"t={T - 1} [{card}]: mean |delta| "
           + " ".join(f"{d[t].mean().item():.1e}" for t in steps) + "; max |delta| "
           + " ".join(f"{d[t].max().item():.1e}" for t in steps) + "; the control's mean "
           + " ".join(f"{c[t].mean().item():.1e}" for t in steps))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("p1_band: no CUDA device available", file=sys.stderr)
        return 1
    draws = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    card = cs.card_line()
    with torch.no_grad():
        for cell in CELLS:
            for B in (1, 3, 24):
                bands(torch, cell, B, draws, card)
        walk(torch, card)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
