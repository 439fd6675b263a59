"""Model conversion CLI.

Replaces the reference's offline exporter pipeline (misc/taiyaki_*.py,
misc/parse_*.py): converts between
- reference C weight headers / .mdl files  (parse + emit),
- torch/taiyaki checkpoints                (import),
- sloika pickles                          (import),
- this package's npz checkpoints           (native format).

A copy of flappie_tpu/cli/convert.py for the port (flappie-torch-convert):
the same subcommands write the same files.  It computes nothing on a
device, so it has no --device.

Examples:
    python -m flappie_tpu_torch.cli.convert header2npz model.h out.npz
    python -m flappie_tpu_torch.cli.convert npz2header out.npz model.h --model r941_native --id r941native
    python -m flappie_tpu_torch.cli.convert torch2npz ckpt.pt out.npz --model r941_native [--scale]
    python -m flappie_tpu_torch.cli.convert sloika2npz model.pkl out.npz --flavour flipflop_gru
    python -m flappie_tpu_torch.cli.convert synth out.npz --model r941_native --seed 0
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="flappie-torch-convert", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    h2n = sub.add_parser("header2npz", help="reference C header/.mdl -> npz")
    h2n.add_argument("header")
    h2n.add_argument("npz")
    h2n.add_argument("--head", default=None, help="override head (e.g. runlengthV2)")

    n2h = sub.add_parser("npz2header", help="npz -> reference C header")
    n2h.add_argument("npz")
    n2h.add_argument("header")
    n2h.add_argument("--model", required=True)
    n2h.add_argument("--id", default="model")

    t2n = sub.add_parser("torch2npz", help="torch/taiyaki checkpoint -> npz")
    t2n.add_argument("ckpt")
    t2n.add_argument("npz")
    t2n.add_argument("--model", required=True)
    t2n.add_argument("--scale", action="store_true",
                     help="apply x1.4826 MAD scale to the first conv")

    s2n = sub.add_parser(
        "sloika2npz",
        help="legacy sloika pickle -> npz (misc/parse_*.py replacement)",
    )
    s2n.add_argument("pickle")
    s2n.add_argument("npz")
    s2n.add_argument(
        "--flavour", required=True,
        choices=("flipflop_gru", "flipflop_grumod", "runlength"),
        help="which reference parser the pickle targets: parse_flipflop"
             " | parse_flipflop_guppy | parse_runlen",
    )
    s2n.add_argument("--name", default="sloika")

    sy = sub.add_parser("synth", help="deterministic synthetic checkpoint")
    sy.add_argument("npz")
    sy.add_argument("--model", required=True)
    sy.add_argument("--seed", type=int, default=0)

    args = p.parse_args(argv)

    from ..models.config import get_model_config
    from ..models.params import init_synthetic, load_npz, save_npz, validate

    if args.cmd == "header2npz":
        from ..weights import config_from_arrays, convert_reference_header

        with open(args.header) as fh:
            text = fh.read()
        cfg, params = convert_reference_header(text)
        if args.head:
            cfg = config_from_arrays(cfg, args.head)
        save_npz(args.npz, params, cfg)
        print(f"wrote {args.npz}: {cfg.head} nbase={cfg.nbase} "
              f"convs={[c.out_ch for c in cfg.convs]} "
              f"rnns={[(r.kind, r.size, 'B' if r.backward else 'F') for r in cfg.rnns]}")
    elif args.cmd == "npz2header":
        from ..weights import emit_model_header

        cfg = get_model_config(args.model)
        params = load_npz(args.npz)
        validate(params, cfg)
        with open(args.header, "w") as fh:
            fh.write(emit_model_header(cfg, params, modelid=args.id))
        print(f"wrote {args.header}")
    elif args.cmd == "torch2npz":
        from ..weights.taiyaki import convert_state_dict, load_torch_checkpoint

        cfg = get_model_config(args.model)
        state = load_torch_checkpoint(args.ckpt)
        params = convert_state_dict(state, cfg, scale_first_conv=args.scale)
        save_npz(args.npz, params, cfg)
        print(f"wrote {args.npz}")
    elif args.cmd == "sloika2npz":
        from ..weights.sloika import convert_sloika_pickle, save_sloika_npz

        cfg, params = convert_sloika_pickle(args.pickle, args.flavour, args.name)
        save_sloika_npz(args.npz, cfg, params)
        print(f"wrote {args.npz}: {cfg.head} nbase={cfg.nbase} "
              f"convs={[c.out_ch for c in cfg.convs]} "
              f"rnns={[(r.kind, r.size, 'B' if r.backward else 'F') for r in cfg.rnns]}")
    elif args.cmd == "synth":
        cfg = get_model_config(args.model)
        params = init_synthetic(cfg, seed=args.seed)
        save_npz(args.npz, params, cfg)
        print(f"wrote {args.npz}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
