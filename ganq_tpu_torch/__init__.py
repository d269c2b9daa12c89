"""ganq_tpu_torch: the PyTorch / CUDA port of ganq_tpu for NVIDIA Hopper.

Quantizes a dense llama-family checkpoint with GANQ and serves packed
``lut`` checkpoints: ``GanqModel.load(dense_dir, qcfg)``, ``quantize``,
``save``, ``GanqModel.load(dir)``, ``generate``, on the card by default
(``device="cpu"`` runs the plain PyTorch versions of the kernels). The JAX package ``ganq_tpu`` is the
reference this package is held against; nothing here imports it.
"""

from .api import GanqModel
from .core.config import FORMAT, QUANT_METHOD, QuantizeConfig

__all__ = ["GanqModel", "QuantizeConfig", "FORMAT", "QUANT_METHOD"]
