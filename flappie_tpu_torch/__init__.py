"""flappie-tpu-torch: the flappie-tpu basecaller ported to PyTorch and CUDA.

A second package beside ``flappie_tpu`` (the JAX reference, which stays
as it is).  The layout mirrors it module for module: host-side signal
handling and output formatting are numpy copies, the network and decode
are PyTorch, and every TPU (Pallas) kernel on the ported path has a
hand-written CUDA counterpart under ``csrc/`` with its plain PyTorch
version beside its wrapper (``ops/rnn_cuda.py``, ``ops/crf_bm_cuda.py``).

The port imports nothing of ``flappie_tpu`` and never imports ``jax``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import torch

__version__ = "0.1.0"

# The f32 parity tier.  cuDNN runs float32 convolutions in TF32 by
# default (about three decimal digits), which is far outside the 5e-6
# transition-weight band the port keeps against the JAX package; matmuls
# default to full f32 but are pinned here as well, so no caller's global
# setting can move the port off true float32.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device.

    There is no quiet fallback: without a GPU the default raises, and
    the CPU runs only when asked for (``device="cpu"``, CLI ``--device
    cpu``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flappie_tpu_torch: no CUDA device is available; pass "
            "device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return dev
