from .config import (
    FLAPPIE_MODELS,
    MODELS,
    ModelConfig,
    get_model_config,
    nbase_from_flipflop_nparam,
)
from .network import transitions
from .params import init_synthetic, load_npz, params_to_torch, save_npz
