"""Quantizers: Hessian capture, the shared preamble, GANQ and the layer-wise
loop."""
