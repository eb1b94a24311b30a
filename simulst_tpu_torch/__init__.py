"""simulst_tpu_torch: the PyTorch + CUDA port of simulst_tpu for NVIDIA Hopper.

The JAX package `simulst_tpu` stays the reference; this package mirrors its
layout (`nn/`, `ops/`, `models/`, `losses/`, `train/`, `data/`, `decode/`,
`stream/`, `cli/`, `compat/`) so every module has an obvious counterpart.
Plain tensor code is PyTorch; every Pallas kernel on the ported paths
(serving s2t_emformer, training the MT teacher, training s2t_emformer with
joint CTC, training MMA and its streaming step) is a hand-written CUDA
kernel under
`csrc/`, built with nvcc at first use (`ops/_build.py`), differentiable
through a `torch.autograd.Function` where the path trains.  On a CPU tensor
a kernel wrapper runs its plain PyTorch version; on a CUDA tensor it
launches the kernel or raises.  Entry points run on the card unless the
caller names another device.

This package never imports JAX or the JAX package.
"""

__version__ = "0.1.0"
