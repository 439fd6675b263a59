"""The run's environment: the program's knobs, its caches, the modules
that may not load, the card, and the process's age."""

from __future__ import annotations

import os
import sys

from .spec import ROOT

# top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "flappie_tpu")
# build and kernel caches, at fixed paths inside the checkout (build/ is
# ignored by git); the program's nvcc libraries already live in
# build/flappie_tpu_torch/
CACHE_DIR = os.path.join(ROOT, "build", "bench_cache")


def apply(config: dict) -> None:
    """Only the configuration's FLAPPIE_TPU_* knobs, every other one
    removed, so a cell runs the defaults users get unless its file says
    otherwise; every cache inside the checkout."""
    for k in [k for k in os.environ if k.startswith("FLAPPIE_TPU_")]:
        del os.environ[k]
    os.environ.update({k: str(v) for k, v in config.get("knobs", {}).items()})
    for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)


def forbidden_loaded() -> list:
    """The forbidden top-level names among the loaded modules, each
    compared whole (``flappie_tpu_torch`` is not ``flappie_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def require_cards(chips: int) -> str:
    """The card's name, or an error message when the run cannot have
    ``chips`` cards."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("benchmark: torch.cuda.is_available() is false; no result")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"benchmark: {torch.cuda.device_count()} CUDA devices, the cell needs "
                         f"{chips}; no result")
    return torch.cuda.get_device_name(0)


def process_age_s() -> float:
    """Seconds since this process started (its start time in clock ticks
    after boot, against the uptime now)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as fh:
        return float(fh.read().split()[0]) - start
