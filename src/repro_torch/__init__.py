"""PyTorch port of the AdaFBiO reproduction, for one NVIDIA H100.

Same module layout as the JAX package it was ported from; parameters are
plain nested dicts of tensors, the device is explicit (entry points default
to ``"cuda"`` and raise without a card), and randomness comes from explicit
``torch.Generator``s or from draw tensors handed in by the caller. The two
fused update kernels on the training path and the int8 codec's quantize and
dequantize are hand-written CUDA (``kernels/csrc/``); their plain PyTorch
versions (``kernels/ref.py``) serve CPU tensors.
"""
