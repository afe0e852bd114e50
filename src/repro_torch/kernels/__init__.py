"""The fused IRC MVM: its Hopper CUDA kernel (`irc_mvm`), its plain PyTorch
version (`ref`) and the dispatching entry points (`ops`)."""
