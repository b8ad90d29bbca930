"""Hand-written Hopper kernels of the port, their plain PyTorch twins and
the wrappers the protocol core calls (:mod:`repro_torch.kernels.ops`)."""
