"""PyTorch/CUDA port of the IRC detector's chip-population Monte Carlo.

The JAX package `repro` is the reference this package is held against; this
package never imports it (or JAX).  The fused IRC MVM runs as a hand-written
CUDA kernel for Hopper (`csrc/irc_mvm.cu`); everything else is plain
PyTorch.  The reference computes in true float32, so TF32 is switched off
for matmuls and cuDNN convolutions as soon as the package is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
