"""PyTorch/CUDA port of revisiting_at_tpu.

Same subpackage layout and module names as the JAX package, which stays the
reference. Public functions keep its contract: NHWC images in [0, 1], logits
[B, classes]. The fused block-tail kernels are hand-written CUDA for Hopper
(csrc/block_mlp.cu); everything else is plain PyTorch.
"""

__version__ = "0.1.0"
