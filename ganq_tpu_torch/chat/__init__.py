"""Interactive chat over a quantized checkpoint (``python -m
ganq_tpu_torch.chat.cli``)."""
