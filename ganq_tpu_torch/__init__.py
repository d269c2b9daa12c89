"""ganq_tpu_torch: the PyTorch / CUDA port of ganq_tpu for NVIDIA Hopper.

Serves packed GANQ ``lut`` checkpoints: ``GanqModel.load(dir)`` then
``generate(...)``, on the card by default (``device="cpu"`` runs the plain
PyTorch versions of the kernels). The JAX package ``ganq_tpu`` is the
reference this package is held against; nothing here imports it.
"""

from .api import GanqModel
from .core.config import FORMAT, QUANT_METHOD, QuantizeConfig

__all__ = ["GanqModel", "QuantizeConfig", "FORMAT", "QUANT_METHOD"]
