"""Weight converters (counterpart of flappie_tpu/weights): reference C
headers (parse and emit), taiyaki/torch checkpoints and sloika pickles
to and from the port's numpy parameter trees.  Numpy copies of the JAX
package's modules: the port imports nothing of that package."""

from .header_emit import emit_model_header
from .header_parser import (
    config_from_arrays,
    convert_reference_header,
    parse_model_header,
)
