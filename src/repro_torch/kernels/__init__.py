"""The port's Hopper CUDA kernels: the fused IRC MVM (`irc_mvm`), the
ternary matmul (`ternary_matmul`) and causal flash attention
(`flash_attention_cuda`; the package exports the op `flash_attention`
itself), their shared nvcc build (`build`), their plain PyTorch versions
(`ref`) and the dispatching entry points (`ops`)."""
from repro_torch.kernels.ops import flash_attention
from repro_torch.kernels.ref import flash_attention_ref
