"""EoRA accuracy-recovery adapters (``adapter/eora.py``)."""
