"""PyTorch port on the CPU: the weight converters (flappie_tpu_torch/weights,
cli/convert.py) against the JAX package's, on the same inputs.

- ``emit_model_header``: the header text byte-equal for r941_native,
  r941_5mC and rle_r941_native synthetic weights (each model's graph at
  16 recurrent units, registered under its own name in both packages for
  the length of a test: the hex-float text of a full-width model takes
  seconds a package);
- ``convert_reference_header``: arrays and configs equal;
- ``convert_state_dict``: equal on synthetic taiyaki state dicts (LSTM,
  and GRU with the cudnn -> guppy gate reorder), with and without the MAD
  scale of the first conv;
- ``convert_sloika_pickle`` / ``save_sloika_npz`` / ``load_sloika_npz``:
  equal for the three flavours, on stub-forcing pickles written by
  tests/test_torch_sloika.py's ``write_sloika_pickle``;
- every ``flappie-torch-convert`` subcommand against ``flappie-convert``:
  the files written byte-equal, and the lines printed equal.

Everything here is numpy on the host: no tolerance.
"""

from __future__ import annotations

from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

from flappie_tpu.cli.convert import main as j_convert
from flappie_tpu.models import config as j_config
from flappie_tpu.models.config import get_model_config as j_get_model_config
from flappie_tpu.models.params import init_synthetic as j_init_synthetic
from flappie_tpu.weights import header_emit as j_emit
from flappie_tpu.weights import header_parser as j_parser
from flappie_tpu.weights import sloika as j_sloika
from flappie_tpu.weights import taiyaki as j_taiyaki

from flappie_tpu_torch.cli.convert import main as t_convert
from flappie_tpu_torch.models import config as t_config
from flappie_tpu_torch.models.config import get_model_config
from flappie_tpu_torch.models.params import flatten, init_synthetic
from flappie_tpu_torch.weights import header_emit as t_emit
from flappie_tpu_torch.weights import header_parser as t_parser
from flappie_tpu_torch.weights import sloika as t_sloika
from flappie_tpu_torch.weights import taiyaki as t_taiyaki

from test_torch_sloika import write_sloika_pickle

MODELS = [("r941_native", "r941native"), ("r941_5mC", "r941native5mC"),
          ("rle_r941_native", "rle941")]
SMALL = 16  # recurrent units (and the last conv's channels) of the small graphs


def _small(cfg):
    convs = cfg.convs[:-1] + (replace(cfg.convs[-1], out_ch=SMALL),)
    return replace(cfg, convs=convs, rnns=tuple(replace(r, size=SMALL) for r in cfg.rnns))


@pytest.fixture(autouse=True)
def small_models(monkeypatch):
    """The registry models at SMALL units in both packages, under their
    names, for the length of a test (the CLIs take registry names)."""
    for config in (j_config, t_config):
        for name, _ in MODELS:
            monkeypatch.setitem(config.MODELS, name, _small(config.MODELS[name]))


def _same_params(a, b):
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype == np.float32, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _same_config(a, b):
    assert asdict(a) == asdict(b)


def _header(model, modelid, seed=11):
    params = init_synthetic(get_model_config(model), seed=seed)
    return params, t_emit.emit_model_header(get_model_config(model), params, modelid=modelid)


@pytest.mark.parametrize("model,modelid", MODELS)
def test_emit_model_header_byte_equal(model, modelid):
    params, text = _header(model, modelid)
    want = j_emit.emit_model_header(j_get_model_config(model), params, modelid=modelid)
    assert text == want
    _same_params(params, j_init_synthetic(j_get_model_config(model), seed=11))


@pytest.mark.parametrize("model,modelid", MODELS)
def test_convert_reference_header_equal(model, modelid):
    params, text = _header(model, modelid, seed=12)
    jcfg, jp = j_parser.convert_reference_header(text)
    tcfg, tp = t_parser.convert_reference_header(text)
    _same_config(tcfg, jcfg)
    _same_params(tp, jp)
    _same_params(tp, params)  # the round trip is exact
    arrays_t, defs_t = t_parser.parse_model_header(text)
    arrays_j, defs_j = j_parser.parse_model_header(text)
    assert defs_t == defs_j and sorted(arrays_t) == sorted(arrays_j)
    if model == "rle_r941_native":  # out_dim 40 reads as flip-flop; override
        _same_config(t_parser.config_from_arrays(tcfg, "runlengthV2"),
                     j_parser.config_from_arrays(jcfg, "runlengthV2"))


def _state_dict(model, seed):
    """A synthetic taiyaki state dict of ``model``'s layout: a leading
    parameterless sublayer, the convs, the recurrent layers (LSTM or
    cudnn GRU) and the linear head."""
    cfg = get_model_config(model)
    rng = np.random.default_rng(seed)
    state, i = {}, 1
    for c in cfg.convs:
        state[f"sublayers.{i}.conv.weight"] = rng.normal(
            size=(c.out_ch, c.in_ch, c.winlen)).astype(np.float32)
        state[f"sublayers.{i}.conv.bias"] = rng.normal(size=(c.out_ch,)).astype(np.float32)
        i += 1
    d_in = cfg.convs[-1].out_ch
    for r in cfg.rnns:
        G = 4 if r.kind == "lstm" else 3
        name = "lstm" if r.kind == "lstm" else "cudnn_gru"
        state[f"sublayers.{i}.{name}.weight_ih_l0"] = rng.normal(
            size=(G * r.size, d_in)).astype(np.float32)
        state[f"sublayers.{i}.{name}.weight_hh_l0"] = rng.normal(
            size=(G * r.size, r.size)).astype(np.float32)
        state[f"sublayers.{i}.{name}.bias_ih_l0"] = rng.normal(size=(G * r.size,)).astype(np.float32)
        d_in, i = r.size, i + 1
    state[f"sublayers.{i}.linear.weight"] = rng.normal(size=(cfg.out_dim, d_in)).astype(np.float32)
    state[f"sublayers.{i}.linear.bias"] = rng.normal(size=(cfg.out_dim,)).astype(np.float32)
    return state


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("model", ["r941_native", "r941_5mC"])
def test_convert_state_dict_equal(model, scale):
    state = _state_dict(model, seed=5)
    want = j_taiyaki.convert_state_dict(state, j_get_model_config(model), scale_first_conv=scale)
    got = t_taiyaki.convert_state_dict(state, get_model_config(model), scale_first_conv=scale)
    _same_params(got, want)
    if model == "r941_5mC":  # the GRU gates reordered, then transposed
        iW = [v for k, v in state.items() if k.endswith("weight_ih_l0")][0]
        np.testing.assert_array_equal(got["rnn0"]["iW"], t_taiyaki.cudnn_to_guppy_gru(iW).T)
        np.testing.assert_array_equal(t_taiyaki.cudnn_to_guppy_gru(iW),
                                      j_taiyaki.cudnn_to_guppy_gru(iW))


@pytest.mark.parametrize("flavour", ["flipflop_gru", "flipflop_grumod", "runlength"])
def test_sloika_conversion_equal(tmp_path, flavour):
    pkl = write_sloika_pickle(tmp_path / "m.pkl", flavour, seed=3, winlen=19)
    jcfg, jp = j_sloika.convert_sloika_pickle(pkl, flavour, name="m1")
    tcfg, tp = t_sloika.convert_sloika_pickle(pkl, flavour, name="m1")
    _same_config(tcfg, jcfg)
    _same_params(tp, jp)
    t_sloika.save_sloika_npz(str(tmp_path / "t.npz"), tcfg, tp)
    j_sloika.save_sloika_npz(str(tmp_path / "j.npz"), jcfg, jp)
    assert (tmp_path / "t.npz").read_bytes() == (tmp_path / "j.npz").read_bytes()
    cfg2, p2 = t_sloika.load_sloika_npz(str(tmp_path / "t.npz"))
    _same_config(cfg2, j_sloika.load_sloika_npz(str(tmp_path / "j.npz"))[0])
    _same_params(p2, tp)


def test_sloika_version_gate(tmp_path):
    """A version-1 network is refused with the JAX package's message."""
    pkl = write_sloika_pickle(tmp_path / "old.pkl", "flipflop_grumod", version=(1, 1))
    with pytest.raises(ValueError, match="version >= 2") as got:
        t_sloika.convert_sloika_pickle(pkl, "flipflop_grumod")
    with pytest.raises(ValueError) as want:
        j_sloika.convert_sloika_pickle(pkl, "flipflop_grumod")
    assert str(got.value) == str(want.value)


def _run_both(tmp_path, capsys, make_args, outputs):
    """Run one subcommand through each CLI into its own directory: the
    files written byte-equal, the printed lines equal but for the paths."""
    printed = {}
    for name, main in (("jax", j_convert), ("port", t_convert)):
        d = tmp_path / name
        d.mkdir(parents=True)
        assert main(make_args(d)) == 0
        printed[name] = capsys.readouterr().out.replace(str(d), "DIR")
    assert printed["port"] == printed["jax"] and printed["port"].startswith("wrote DIR/")
    for out in outputs:
        ours, theirs = (tmp_path / "port" / out).read_bytes(), (tmp_path / "jax" / out).read_bytes()
        assert len(ours) > 0 and ours == theirs, out


def test_cli_synth_and_header_subcommands(tmp_path, capsys):
    """synth, npz2header, header2npz (with and without --head)."""
    src = tmp_path / "src"
    src.mkdir()
    assert t_convert(["synth", str(src / "m.npz"), "--model", "rle_r941_native", "--seed", "3"]) == 0
    capsys.readouterr()
    cases = [
        (lambda d: ["synth", str(d / "s.npz"), "--model", "r941_5mC", "--seed", "4"], ["s.npz"]),
        (lambda d: ["npz2header", str(src / "m.npz"), str(d / "m.h"), "--model", "rle_r941_native",
                    "--id", "rle941"], ["m.h"]),
    ]
    for i, (args, outs) in enumerate(cases):
        _run_both(tmp_path / f"case{i}", capsys, args, outs)
    hdr = tmp_path / "case1" / "port" / "m.h"
    for i, head in enumerate(([], ["--head", "runlengthV2"])):
        _run_both(tmp_path / f"h2n{i}", capsys,
                  lambda d, head=head: ["header2npz", str(hdr), str(d / "m.npz")] + head,
                  ["m.npz"])


@pytest.mark.parametrize("scale", [False, True])
def test_cli_torch2npz(tmp_path, capsys, scale):
    state = {k: torch.from_numpy(v) for k, v in _state_dict("r941_5mC", seed=6).items()}
    ckpt = tmp_path / "ckpt.pt"
    torch.save({"model_state_dict": state}, str(ckpt))
    _run_both(tmp_path / "run", capsys,
              lambda d: ["torch2npz", str(ckpt), str(d / "m.npz"), "--model", "r941_5mC"]
              + (["--scale"] if scale else []), ["m.npz"])


@pytest.mark.parametrize("flavour", ["flipflop_gru", "flipflop_grumod", "runlength"])
def test_cli_sloika2npz(tmp_path, capsys, flavour):
    pkl = write_sloika_pickle(tmp_path / "m.pkl", flavour, seed=7)
    _run_both(tmp_path / "run", capsys,
              lambda d: ["sloika2npz", str(pkl), str(d / "m.npz"), "--flavour", flavour,
                         "--name", "m7"], ["m.npz"])
