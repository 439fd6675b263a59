"""Legacy sloika pickle parsers.

Replacement for the reference's sloika-era exporters
(misc/parse_flipflop.py, misc/parse_flipflop_guppy.py,
misc/parse_runlen.py): load a pickled sloika network and convert it to
this package's (ModelConfig, params) pair, instead of emitting a C
weight header.

Sloika pickles reference sloika/theano classes that are long dead, so
loading uses a permissive unpickler: any class that cannot be imported
is replaced by a duck-typed stub that records its state; parameter
values are recovered by searching each stub for its numpy payload
(theano shared variables pickle their ndarray inside their state).
Structure navigation mirrors the reference parsers exactly: the model
is ``network.sublayers[...]`` with backward layers wrapped in Reverse
(and, for the residual flip-flop graph, Residual) containers -- we
descend through single-child containers until a layer carrying the
expected parameters appears.

Array orientation: sloika stores matrices [out, in] (the reference
parsers' cformatM writes nr=shape[1], nc=shape[0], i.e. C column-major
[in x out]); this package stores [in, out], so every matrix is
transposed.  Gate orders are sloika's own, which the reference consumes
unreordered (gru_step, src/layers.c:513-568) and ops/rnn.py transcribes.

A copy of flappie_tpu/weights/sloika.py (numpy only; the port imports
nothing of the JAX package).  A converted checkpoint runs as in the JAX
package: ``load_sloika_npz`` -> ``Basecaller(model=cfg, params=params)``
for the flip-flop flavours, ``models.network.transitions`` with the
V1 decode of decode/runlength.py for ``runlength``.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Dict, Tuple

import numpy as np

from ..models.config import ConvSpec, ModelConfig, RnnSpec
from ..models.params import Params


class _Stub:
    """Duck-typed stand-in for an unimportable pickled class."""

    _module = _name = ""

    def __init__(self, *args, **kw):
        self._args = args
        self._kw = kw

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<sloika stub {self._module}.{self._name}>"


class _PermissiveUnpickler(pickle.Unpickler):
    """pickle.Unpickler that substitutes stubs for missing classes."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except Exception:
            stub = type(name, (_Stub,), {"_module": module, "_name": name})
            return stub


def load_sloika_pickle(path_or_file) -> Any:
    """Load a sloika model pickle (latin1, as the reference parsers do),
    tolerating missing sloika/theano classes."""
    if hasattr(path_or_file, "read"):
        return _PermissiveUnpickler(path_or_file, encoding="latin1").load()
    with open(path_or_file, "rb") as fh:
        return _PermissiveUnpickler(fh, encoding="latin1").load()


def _ndarray_in(obj, depth: int = 0):
    """First float ndarray reachable from obj (theano shared variables
    bury their value inside container/storage state)."""
    if depth > 6:
        return None
    if isinstance(obj, np.ndarray) and obj.dtype.kind == "f":
        return obj
    if isinstance(obj, (list, tuple)):
        for v in obj:
            a = _ndarray_in(v, depth + 1)
            if a is not None:
                return a
    if isinstance(obj, dict):
        for v in obj.values():
            a = _ndarray_in(v, depth + 1)
            if a is not None:
                return a
    if isinstance(obj, _Stub):
        # unpickled stubs restore via __setstate__ (no __init__ call),
        # so constructor captures may be absent
        for v in (
            list(getattr(obj, "_args", ()))
            + list(getattr(obj, "_kw", {}).values())
            + list(obj.__dict__.values())
        ):
            if v is obj:
                continue
            a = _ndarray_in(v, depth + 1)
            if a is not None:
                return a
    return None


def value_of(param) -> np.ndarray:
    """theano-shared-like -> float32 ndarray (get_value() when live,
    ndarray search when stubbed)."""
    if hasattr(param, "get_value") and callable(param.get_value):
        return np.asarray(param.get_value(), dtype=np.float32)
    a = _ndarray_in(param)
    if a is None:
        raise ValueError(f"no ndarray found inside {param!r}")
    return np.asarray(a, dtype=np.float32)


def _descend(layer, *attrs):
    """Walk through single-child containers (Reverse/Residual/Serial)
    until a layer carrying all of ``attrs`` appears -- the robust form
    of the reference parsers' fixed .sublayers[0](.sublayers[0]) chains."""
    seen = 0
    while not all(hasattr(layer, a) for a in attrs):
        subs = getattr(layer, "sublayers", None)
        if subs is None or len(subs) == 0:
            raise ValueError(
                f"cannot find layer with {attrs} under {layer!r}"
            )
        layer = subs[0]
        seen += 1
        if seen > 6:
            raise ValueError(f"container nesting too deep looking for {attrs}")
    return layer


def _check_version(network) -> None:
    v = getattr(network, "version", None)
    if v is None:
        raise ValueError("not a sloika network pickle (no version)")
    major = v[0] if isinstance(v, tuple) else v
    if major < 2:
        raise ValueError(
            f"Sloika model must be version >= 2 but model is {v} "
            "(run sloika's model_upgrade.py first)"
        )


def _conv_of(network) -> Tuple[Dict[str, np.ndarray], int, int, int]:
    """sublayers[0]: filter [nfilter, 1, winlen] + bias + stride."""
    conv = _descend(network.sublayers[0], "W", "b")
    W = value_of(conv.W)  # [nfilter, in=1, winlen]
    nfilter, in_ch, winlen = W.shape
    stride = int(getattr(conv, "stride", 1))
    return (
        {"W": np.ascontiguousarray(W.transpose(2, 1, 0)), "b": value_of(conv.b).reshape(-1)},
        nfilter,
        winlen,
        stride,
    )


def _gru2_of(layer) -> Dict[str, np.ndarray]:
    """sloika 2-matrix GRU (iW [3H, in], sW [2H, H], sW2 [H, H], b)."""
    g = _descend(layer, "iW", "sW", "sW2", "b")
    return {
        "iW": np.ascontiguousarray(value_of(g.iW).T),
        "sW": np.ascontiguousarray(value_of(g.sW).T),
        "sW2": np.ascontiguousarray(value_of(g.sW2).T),
        "b": value_of(g.b).reshape(-1),
    }


def _gru1_of(layer) -> Dict[str, np.ndarray]:
    """single-matrix (guppy/grumod) GRU: iW [3H, in], sW [3H, H], b."""
    g = _descend(layer, "iW", "sW", "b")
    return {
        "iW": np.ascontiguousarray(value_of(g.iW).T),
        "sW": np.ascontiguousarray(value_of(g.sW).T),
        "b": value_of(g.b).reshape(-1),
    }


def _ff_of(network, index: int) -> Dict[str, np.ndarray]:
    ff = _descend(network.sublayers[index], "W", "b")
    return {
        "W": np.ascontiguousarray(value_of(ff.W).T),
        "b": value_of(ff.b).reshape(-1),
    }


def convert_sloika(network, flavour: str, name: str = "sloika") -> Tuple[ModelConfig, Params]:
    """Pickled sloika network -> (ModelConfig, params).

    flavour:
    - ``flipflop_gru``    - misc/parse_flipflop.py: conv+elu, 5
      residual 2-matrix GRUs alternating B/F, flip-flop head
      (flipflop_gru_transitions, src/networks.c:403-448).
    - ``flipflop_grumod`` - misc/parse_flipflop_guppy.py: conv+tanh,
      5 guppy GRUs alternating B/F, flip-flop head
      (flipflop_guppy_transitions, src/networks.c:450-489).
    - ``runlength``       - misc/parse_runlen.py: conv+tanh, 5 guppy
      GRUs, V1 run-length head (runlength_guppy_transitions,
      src/networks.c:589-630).
    """
    _check_version(network)
    conv_p, nfilter, winlen, stride = _conv_of(network)
    params: Params = {"conv0": conv_p}

    if flavour == "flipflop_gru":
        kind, residual, act = "gru", True, "elu"
        extract = _gru2_of
    elif flavour == "flipflop_grumod":
        kind, residual, act = "grumod", False, "tanh"
        extract = _gru1_of
    elif flavour == "runlength":
        kind, residual, act = "grumod", False, "tanh"
        extract = _gru1_of
    else:
        raise ValueError(f"unknown sloika flavour {flavour!r}")

    rnns = []
    for i in range(5):
        p = extract(network.sublayers[1 + i])
        size = p["sW"].shape[0]
        params[f"rnn{i}"] = p
        rnns.append(
            RnnSpec(kind, size, backward=(i % 2 == 0), residual=residual)
        )

    params["ff"] = _ff_of(network, 6)
    out_dim = params["ff"]["W"].shape[1]
    if flavour == "runlength":
        head, nbase = "runlength", out_dim // 4
    else:
        from ..models.config import nbase_from_flipflop_nparam

        head, nbase = "flipflop", nbase_from_flipflop_nparam(out_dim)

    cfg = ModelConfig(
        name=name,
        description=f"sloika {flavour} model converted from pickle",
        convs=(ConvSpec(winlen=winlen, in_ch=1, out_ch=nfilter,
                        stride=stride, activation=act),),
        rnns=tuple(rnns),
        head=head,
        nbase=nbase,
    )
    from ..models.params import validate

    validate(params, cfg)
    return cfg, params


def convert_sloika_pickle(path, flavour: str, name: str = "sloika") -> Tuple[ModelConfig, Params]:
    return convert_sloika(load_sloika_pickle(path), flavour, name)


def save_sloika_npz(path: str, cfg: ModelConfig, params: Params) -> None:
    """npz with enough structural metadata (flavour markers, conv
    stride) to rebuild the non-registry sloika ModelConfig on load."""
    from ..models.params import flatten

    flat = {k: np.asarray(v) for k, v in flatten(params).items()}
    flat["__model_name__"] = np.array(cfg.name)
    flat["__sloika__"] = np.array(
        [cfg.rnns[0].kind, cfg.convs[0].activation, cfg.head,
         str(int(cfg.rnns[0].residual)), str(cfg.convs[0].stride)]
    )
    np.savez(path, **flat)


def load_sloika_npz(path: str) -> Tuple[ModelConfig, Params]:
    from ..models.config import nbase_from_flipflop_nparam
    from ..models.params import unflatten, validate

    with np.load(path, allow_pickle=False) as z:
        if "__sloika__" not in z.files:
            raise ValueError(f"{path}: not a sloika checkpoint")
        kind, act, head, residual, stride = (str(x) for x in z["__sloika__"])
        name = str(z["__model_name__"]) if "__model_name__" in z.files else "sloika"
        flat = {k: z[k] for k in z.files if not k.startswith("__")}
    params = unflatten(flat)
    winlen, in_ch, nfilter = params["conv0"]["W"].shape
    nrnn = sum(1 for k in params if k.startswith("rnn"))
    rnns = tuple(
        RnnSpec(kind, params[f"rnn{i}"]["sW"].shape[0],
                backward=(i % 2 == 0), residual=bool(int(residual)))
        for i in range(nrnn)
    )
    out_dim = params["ff"]["W"].shape[1]
    nbase = out_dim // 4 if head == "runlength" else nbase_from_flipflop_nparam(out_dim)
    cfg = ModelConfig(
        name=name,
        description="sloika model (npz)",
        convs=(ConvSpec(winlen=winlen, in_ch=in_ch, out_ch=nfilter,
                        stride=int(stride), activation=act),),
        rnns=rnns,
        head=head,
        nbase=nbase,
    )
    validate(params, cfg)
    return cfg, params
