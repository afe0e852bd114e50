"""The port's Hopper CUDA kernels: the fused IRC MVM (`irc_mvm`) and the
ternary matmul (`ternary_matmul`), their shared nvcc build (`build`), their
plain PyTorch versions (`ref`) and the dispatching entry points (`ops`)."""
